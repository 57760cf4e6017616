"""Time the PCG band's Hessian-vector product at the benchmark's shapes on
one GPU.

    python3 tools/bench_pcg_hvp.py [--root build/prev_tree] [--tag current]
        [--batch 2048] [--out chiprun_out/bench_pcg_hvp.jsonl]

Imports the port from ``--root`` (default: this repository; another
version, for a comparison, is a ``git archive`` of it in the ignored
``build/``) and, at ``hospital_2robot_cap1024.fleet_pcg``'s shapes — the
merged two-robot graph (``sim.graphs.build_merged_batch``) under its chain
order, ``--batch`` graphs, one column — and at a batch-1 call with 48
columns (the exchange's marginal solves of 16 vertices), it times
``solver.pcg._hvp`` as the CG body calls it (on a direction laid out as
the preconditioner's solve leaves it): ``ms`` (CUDA events over
back-to-back calls), ``device_ms`` (a CUDA graph of the calls replayed:
device time only) and ``host_us`` (host clock per call), and counts the
device operations (kernels, copies, fills) one call launches, under
``torch.profiler``.

Where the package has the kernel pair (``ops/pcg_hvp.py``), it also builds
it (cold when ``build/kernels/`` has no library of this source: the
build's seconds are printed), prints ``ptxas -v``'s report, checks the
kernel against the plain version (within 1e-5 of each row's
``Σ|Jᵀ||Ω||J||x|``), times the plain version and gives the function's
bytes bound (``utils/cuda_timing.hvp_bound``), beside the bytes and time
that the pair's split into two passes adds (``scratch_bytes``,
``scratch_ms``). :func:`hvp_records` is the set-up that
``chip_smoke.py`` shares. One JSON line a shape, with the card's name and
power limit, appended to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5


def count_device_ops(fn, calls: int = 3) -> float:
    """Device operations (kernels, copies, fills) a call of ``fn``
    launches, counted by ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA) / calls


def hvp_record(name: str, g, f, x) -> dict:
    """``_hvp(g, f, x)`` timed and counted; with the kernel pair, checked
    against the plain version, which is timed too, beside the bound."""
    import torch

    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    call = (lambda: P._hvp(g, f, x))      # noqa: E731
    rec = {"name": name, "shape": list(x.shape),
           "edges": int(g.e_ij.shape[-2]),
           "ms": CT.event_ms(call), "device_ms": CT.graph_ms(call),
           "host_us": CT.host_us(call),
           "device_ops_per_call": count_device_ops(call)}
    if hasattr(P, "_hvp_plain"):
        from cg_mrslam_tpu_torch.ops.pcg_hvp import PCG_HVP

        before = PCG_HVP.launches
        got = call()
        assert PCG_HVP.launches == before + 1, "the kernel pair did not run"
        want = P._hvp_plain(g, f, x)
        fa = f._replace(Ji=f.Ji.abs(), Jj=f.Jj.abs(), omega=f.omega.abs())
        scale = P._hvp_plain(g, fa, x.abs())
        torch.cuda.synchronize()
        ratio = float(((got - want).abs() / (REL * scale).clamp(
            min=torch.finfo(x.dtype).tiny)).max())
        assert bool(torch.isfinite(got).all()) and ratio <= 1.0, ratio
        b = g.e_ij.shape[0] if g.e_ij.dim() == 3 else 1
        c = x[..., 0, 0].numel() // b
        n, e, s = x.shape[-2], g.e_ij.shape[-2], x.element_size()
        listed = int(f.segs.offsets[-1])
        bound_ms, bound_by = CT.hvp_bound(b, c, n, e, listed, s)
        own_bytes, _ = CT.hvp_work(b, c, n, e, listed, s)
        scratch = CT.hvp_scratch_bytes(b, c, e, listed, s)
        rec.update(
            err_over_bar=ratio, listed_ends=listed,
            plain_ms=CT.event_ms(lambda: P._hvp_plain(g, f, x), reps=5),
            bound_ms=bound_ms, bound_by=bound_by, bytes=own_bytes,
            scratch_bytes=scratch,
            scratch_ms=scratch / CT.HBM_BYTES_PER_S * 1e3)
    return rec


def hvp_records(batch: int) -> list:
    """:func:`hvp_record` at ``fleet_pcg``'s shapes (``batch`` merged
    graphs under the chain order, one column) and at a batch-1 call of
    its graph 0 with 3Q = 48 columns (the exchange's marginal solves of 16
    vertices), each on a direction as the CG body passes it: the
    preconditioner's solve of a random residual."""
    import torch

    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P

    g, order, _ = build_merged_batch(batch, device="cuda")
    g = permute_vertices(g, order)
    one = dataclasses.replace(g, **{k.name: getattr(g, k.name)[0]
                                    for k in dataclasses.fields(g)})
    gen = torch.Generator("cuda").manual_seed(0)
    recs = []
    for name, gr, cols in ((f"pcg_hvp[fleet_pcg {batch}]", g, ()),
                           ("pcg_hvp[batch-1, 48 columns]", one, (48,))):
        f = P._factorize(gr, None)
        r = torch.randn(cols + gr.poses.shape, device="cuda", generator=gen)
        recs.append(hvp_record(name, gr, f, P._tridiag_precond(gr, f)(r)))
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--tag", default="current")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "bench_pcg_hvp.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    if not torch.cuda.is_available():
        print("bench_pcg_hvp: no CUDA device is available", file=sys.stderr)
        return 2
    card = CT.card_line()
    print(card, f"torch {torch.__version__}", f"package {P.__file__}",
          flush=True)
    if hasattr(P, "_hvp_plain"):
        from cg_mrslam_tpu_torch.ops import correlate as K
        from cg_mrslam_tpu_torch.ops import pcg_hvp as PH

        t0 = time.perf_counter()
        PH.PCG_HVP._entry(torch.float32)
        print(f"build and load: {time.perf_counter() - t0:.2f} s", flush=True)
        print(f"ptxas -v:\n{K.ptxas_report(PH.SRC)}", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for rec in hvp_records(args.batch):
            rec.update(tag=args.tag, card=card)
            line = json.dumps(rec)
            print(line, flush=True)
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
