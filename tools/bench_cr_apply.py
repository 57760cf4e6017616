"""Time the PCG preconditioner's cyclic-reduction solve at the benchmark's
shapes on one GPU.

    python3 tools/bench_cr_apply.py [--root build/prev_tree] [--tag current]
        [--batch 2048] [--star 128] [--out chiprun_out/bench_cr_apply.jsonl]

Imports the port from ``--root`` (default: this repository; another
version, for a comparison, is a ``git archive`` of it in the ignored
``build/``) and times the preconditioner as the CG body calls it
(``solver.pcg._tridiag_precond``'s closure: the masked solve of every
column) at ``hospital_2robot_cap1024.fleet_pcg``'s shapes — ``--batch``
merged two-robot graphs (``sim.graphs.build_merged_batch``) under their
chain order, one column — and at ``hospital_2robot_cap1024_star128.
star_optimal``'s marginals — ``--star`` of those graphs, 384 columns:
``ms`` (CUDA events over back-to-back calls), ``device_ms`` (a CUDA graph
of the calls replayed: device time only) and ``host_us`` (host clock per
call), and counts the device operations (kernels, copies, fills) one call
launches, under ``torch.profiler``.

Where the package has the kernel (``ops/cr_apply.py``), it also builds it
(cold when ``build/kernels/`` has no library of this source: the build's
seconds are printed), prints ``ptxas -v``'s report, checks the kernel
against the plain version (its error against the same factor's float64
solve at most twice the plain version's), times the plain version, and
gives the solve's bound (``utils/cuda_timing.cr_apply_bound``: the compact
factor, ``free``, ``r`` and ``z`` once each, against its operations) and
the compact factor's bytes. One JSON line a shape, with the card's name
and power limit, appended to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

try:
    from bench_pcg_hvp import count_device_ops
except ImportError:                 # imported as tools.bench_cr_apply
    from tools.bench_pcg_hvp import count_device_ops

ROOT = Path(__file__).resolve().parents[1]
COLUMNS = 384


def cr_check(fact, r, free) -> dict:
    """One launch of the kernel on ``r [B, C, N, 3]`` against the plain
    version: each held to the same factor's solve in float64 (in float32
    the kernel's error at most twice the plain version's and 1e-6 of the
    answer's scale; in float64 within 1e-9 of it)."""
    import torch

    from cg_mrslam_tpu_torch.ops import cr_apply as CA

    before = CA.CR_APPLY.launches
    got = CA.CR_APPLY(fact, r, free)
    assert CA.CR_APPLY.launches == before + 1, "the kernel did not run"
    want = CA.cr_apply_plain(fact, r, free)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    if r.dtype == torch.float64:
        err_k = float((got - want).abs().max())
        assert err_k <= 1e-9 * scale, (err_k, scale)
        return {"err": err_k, "err_plain": 0.0, "scale": scale}
    exact = CA.cr_apply_plain(
        dataclasses.replace(fact, packed=fact.packed.double()), r.double(),
        free)
    err_k = float((got.double() - exact).abs().max())
    err_p = float((want.double() - exact).abs().max())
    assert err_k <= 2 * err_p + 1e-6 * scale, (err_k, err_p, scale)
    return {"err": err_k, "err_plain": err_p, "scale": scale}


def cr_record(name: str, g, f, cols: tuple) -> dict:
    """The preconditioner of graph batch ``g`` (factors ``f``) on a random
    residual of ``cols`` columns a graph, timed and counted; with the
    kernel, checked against the plain version, which is timed too, beside
    the bound."""
    import torch

    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    gen = torch.Generator("cuda").manual_seed(0)
    b, n = g.poses.shape[0], g.poses.shape[-2]
    r = torch.randn((b,) + cols + (n, 3), device="cuda", generator=gen)
    precond = P._tridiag_precond(g, f)
    call = (lambda: precond(r))      # noqa: E731
    rec = {"name": name, "shape": list(r.shape),
           "ms": CT.event_ms(call), "device_ms": CT.graph_ms(call),
           "host_us": CT.host_us(call),
           "device_ops_per_call": count_device_ops(call)}
    if hasattr(P, "_tridiag_factor"):
        from cg_mrslam_tpu_torch.ops import cr_apply as CA

        fact = P._tridiag_factor(g, f)
        r4 = r.reshape(b, -1, n, 3)
        rec.update(cr_check(fact, r4, f.free))
        c = r4.shape[1]
        bound_ms, bound_by = CT.cr_apply_bound(b, c, n, fact.m)
        n_bytes, n_ops = CT.cr_apply_work(b, c, n, fact.m)
        p = CA.plan(b, c, fact.m, 4, CA.CR_APPLY._smem_limit,
                    torch.cuda.get_device_properties(0).multi_processor_count)
        rec.update(
            plain_ms=CT.event_ms(lambda: CA.cr_apply_plain(fact, r4, f.free),
                                 reps=5),
            bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
            operations=n_ops, factor_bytes=fact.packed.numel() * 4,
            bound_share=bound_ms / rec["device_ms"], plan=p._asdict())
    return rec


def cr_records(batch: int, star: int) -> list:
    """:func:`cr_record` at ``fleet_pcg``'s shapes (``batch`` merged graphs
    under the chain order, one column) and at the star's (the first
    ``star`` of them, 384 columns)."""
    import torch

    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import pcg as P

    g, order, _ = build_merged_batch(batch, device="cuda")
    g = permute_vertices(g, order)
    recs = [cr_record(f"cr_apply[fleet_pcg {batch}]", g, P._factorize(g, None),
                      ())]
    torch.cuda.empty_cache()
    s = dataclasses.replace(g, **{k.name: getattr(g, k.name)[:star]
                                  for k in dataclasses.fields(g)})
    del g
    recs.append(cr_record(f"cr_apply[star {star} x {COLUMNS}]", s,
                          P._factorize(s, None), (COLUMNS,)))
    return recs


def cr_edge_records() -> list:
    """:func:`cr_check` where the benchmark's shapes do not reach: a
    65,536-pose hospital ring (its block's buffer too long for shared
    memory, so in device memory) and four merged graphs in float64 with
    six columns."""
    import torch

    from cg_mrslam_tpu_torch.core.graph import permute_vertices
    from cg_mrslam_tpu_torch.ops import cr_apply as CA
    from cg_mrslam_tpu_torch.sim.graphs import (build_hospital_batch,
                                                build_merged_batch)
    from cg_mrslam_tpu_torch.solver import pcg as P

    gen = torch.Generator("cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    recs = []
    ring = build_hospital_batch(1, n=65536, closures=16, device="cuda")
    g, order, _ = build_merged_batch(4, device="cuda")
    g = permute_vertices(g, order)
    g = dataclasses.replace(g, **{k: getattr(g, k).double()
                                  for k in ("poses", "e_z", "e_info")})
    for name, gr, c in (("cr_apply[hospital 65536 poses]", ring, 1),
                        ("cr_apply[float64 merged 4 x 6]", g, 6)):
        f = P._factorize(gr, None)
        fact = P._tridiag_factor(gr, f)
        b, n = gr.poses.shape[0], gr.poses.shape[-2]
        r = torch.randn((b, c, n, 3), device="cuda", generator=gen,
                        dtype=gr.poses.dtype)
        rec = {"name": name, "shape": list(r.shape), **cr_check(fact, r,
                                                               f.free)}
        p = CA.plan(b, c, fact.m, r.element_size(), CA.CR_APPLY._smem_limit,
                    sms)
        rec["plan"] = p._asdict()
        recs.append(rec)
    assert recs[0]["plan"]["scratch"] > 0, recs[0]
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--tag", default="current")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--star", type=int, default=128)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "bench_cr_apply.jsonl"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    if not torch.cuda.is_available():
        print("bench_cr_apply: no CUDA device is available", file=sys.stderr)
        return 2
    card = CT.card_line()
    print(card, f"torch {torch.__version__}", f"package {P.__file__}",
          flush=True)
    if hasattr(P, "_tridiag_factor"):
        from cg_mrslam_tpu_torch.ops import correlate as K
        from cg_mrslam_tpu_torch.ops import cr_apply as CA

        t0 = time.perf_counter()
        CA.CR_APPLY._entry(torch.float32)
        print(f"build and load: {time.perf_counter() - t0:.2f} s", flush=True)
        print(f"ptxas -v:\n{K.ptxas_report(CA.SRC)}", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for rec in cr_records(args.batch, args.star):
            rec.update(tag=args.tag, card=card)
            line = json.dumps(rec)
            print(line, flush=True)
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
