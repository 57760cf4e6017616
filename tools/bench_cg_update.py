"""Check and time the PCG loop's two vector updates alone at the benchmark's
shapes on one GPU.

    python3 tools/bench_cg_update.py [--batch 2048] [--star 128]
        [--out chiprun_out/bench_cg_update.jsonl]

Builds the update kernels (``ops/cg_update.py``, ``csrc/cg_update.cu``;
cold when ``build/kernels/`` has no library of this source: the build's
seconds are printed), prints ``ptxas -v``'s report (registers, spills),
and times update A and update B as the CG body calls them at
``hospital_2robot_cap1024.fleet_pcg``'s shapes (``--batch`` graphs of
1024 slots, one system each, the GN step's done test on the new
residual, no jitter) and at ``hospital_2robot_cap1024_star128.
star_optimal``'s marginals (``--star`` graphs × 384 columns, the old
residual's test, the 1e-6 jitter), on a batch-1 65,536-pose system (the
split path) and at ``fleet_pcg``'s shapes in float64, every system
active: ``ms`` (CUDA
events over back-to-back calls), ``device_ms`` (a CUDA graph of the calls
replayed: device time only), ``host_us`` (host clock per call), the device
operations a call launches (``torch.profiler``), the bound
(``utils/cuda_timing.cg_update_bound``: each input read once, each output
written once) and the plain version's ``ms`` (``update_a_plain`` /
``update_b_plain`` on the card: the CG body's arithmetic as the loop did
it before the kernels). The inputs are random and the tolerance zero, so
that no system freezes; the updates write in place, so the timed calls
run on drifting values (the time does not depend on them). One JSON line
a (shape, update), with the card's name and power limit, appended to
``--out``.

Before the timing, :func:`check` holds the kernels to their plain version
at the same shapes (:data:`CHECKS`) on :func:`update_inputs`' systems,
some frozen before the call and some freezing in it, and, on some of
them, to the CPU rehearsal of their arithmetic bit for bit
(``tests/test_torch_cg_update.py``); a failed check raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

try:
    from bench_pcg_hvp import count_device_ops
except ImportError:                 # imported as tools.bench_cg_update
    from tools.bench_pcg_hvp import count_device_ops

COLUMNS = 384
N = 1024
RING = 65536
# check(lead, n, dtype name, seed, graphs, rehearse): fleet_pcg's shapes
# (rehearsed whole), the star's (the first graph's columns rehearsed), a
# batch-1 ring (the split path) and float64 (one block, and split)
CHECKS = [((2048,), N, "float32", 1, 2048, slice(0, 2048)),
          ((128, COLUMNS), N, "float32", 2, None, slice(0, 1)),
          ((), RING, "float32", 3, None, ...),
          ((4, 6), N, "float64", 4, None, ...),
          ((8,), 5000, "float64", 5, None, ...)]


def update_inputs(lead, n, dtype, seed=0, device="cpu", graphs=None):
    """One update's inputs ``[*lead, n, 3]`` with every case of the
    ``done`` tests: a quarter of the systems frozen before the call, a
    quarter scaled by 1e-6 (their residuals fall below the tolerance in
    this call), the rest iterating on; ``hp = d·p`` with ``d > 0`` so
    that ``p·hp > 0``, and ``rz`` of the size of ``p·hp`` (so that ``α``
    is near 1, as in a CG loop, and ``α p`` weighs in ``x``); ``free`` over ``graphs`` graphs (by default
    ``lead[0]`` where there are column axes, else one), vertex 0 of each
    not free. Made on ``device``. Returns the tensors and the
    tolerance."""
    import math

    import torch

    gen = torch.Generator(device).manual_seed(seed)
    shape = lead + (n, 3)
    s = math.prod(lead)
    f64 = {"dtype": torch.float64, "device": device}

    def rnd(*sh):
        return torch.randn(sh, generator=gen, **f64)

    scale = torch.ones(s, **f64)
    kind = torch.arange(s, device=device) % 4
    scale[kind == 1] = 1e-6
    p = rnd(s, 3 * n) * scale[:, None]
    d = 0.5 + torch.rand((s, 3 * n), generator=gen, **f64)
    t = {"x": rnd(s, 3 * n), "r": rnd(s, 3 * n) * scale[:, None], "p": p,
         "hp": d * p, "z": rnd(s, 3 * n) * scale[:, None]}
    t = {k: v.reshape(shape).to(dtype) for k, v in t.items()}
    t["rz"] = ((rnd(s).abs() + 0.5) * 3 * n * scale ** 2).reshape(
        lead).to(dtype)
    t["active"] = (kind != 2).reshape(lead)
    if graphs is None:
        graphs = lead[0] if len(lead) > 1 else 1
    free = torch.rand((graphs, n), generator=gen, device=device) > 0.1
    free[:, 0] = False
    t["free"] = free if graphs > 1 else free[0]
    return t, 1e-6 * 3 * n


def _rehearsal():
    try:
        from test_torch_cg_update import rehearse_a, rehearse_b
    except ImportError:
        sys.path.insert(0, str(ROOT / "tests"))
        from test_torch_cg_update import rehearse_a, rehearse_b
    return rehearse_a, rehearse_b


def check(lead, n, dtype, seed, graphs=None, rehearse=None,
          device="cuda") -> dict:
    """One update A (both done tests: the new residual without the
    jitter, the old with it) and one update B on :func:`update_inputs`'
    systems, kernel against plain: the same done flags; the updated
    vectors within 1e-5 of their scale in float32 and 1e-12 in float64
    (each dot product's relative error is ~L·2⁻²⁴ at worst through the
    sums' order); every system frozen before or in the call untouched,
    bit for bit; a repeat bit-equal; and, on the systems ``rehearse``
    selects, the CPU rehearsal bit for bit. Raises ``AssertionError`` on
    a failure; returns the largest error over the scale of each output,
    and the systems frozen in the calls."""
    import torch

    from cg_mrslam_tpu_torch.ops import cg_update as CU

    rel = 1e-5 if dtype == torch.float32 else 1e-12
    keys = ("x", "r", "p", "hp", "rz", "active")
    worst = dict.fromkeys(("x", "r", "p", "rz"), 0.0)
    froze = 0

    def err(got, want, k):
        scale = float(want.abs().max()) or 1.0
        e = float((got - want).abs().max()) / scale
        assert e <= rel, (k, e, rel)
        worst[k] = max(worst[k], e)

    for new_residual, sigma in ((True, 0.0), (False, 1e-6)):
        t, tol = update_inputs(lead, n, dtype, seed, device, graphs)

        def run_a():
            st = {k: t[k].clone() for k in keys}
            before = CU.CG_UPDATE.launches
            got = CU.cg_update_a(*(st[k] for k in keys), t["free"], sigma,
                                 tol, new_residual)
            assert CU.CG_UPDATE.launches == before + 1
            assert got[0] is st["x"] and got[1] is st["r"]
            return st

        st = run_a()
        want = CU.update_a_plain(*(t[k] for k in keys), t["free"], sigma,
                                 tol, new_residual)
        if st["x"].is_cuda:
            torch.cuda.synchronize()
        assert torch.equal(st["active"], want[2])
        if t["rz"].numel() >= 4:          # every case of the done tests
            assert bool(want[2].any())
            assert bool((t["active"] & ~want[2]).any())
        frozen = ~want[2]
        froze += int((t["active"] & frozen).sum())
        for k, w in (("x", want[0]), ("r", want[1])):
            assert bool(torch.isfinite(st[k]).all()), k
            err(st[k], w, k)
            assert torch.equal(st[k][frozen], t[k][frozen]), k
        again = run_a()
        assert all(torch.equal(again[k], st[k]) for k in keys)

        act = want[2]
        pb, rzb = t["p"].clone(), t["rz"].clone()
        CU.cg_update_b(t["r"], t["z"], pb, rzb, act)
        wp, wrz = CU.update_b_plain(t["r"], t["z"], t["p"], t["rz"], act)
        err(pb, wp, "p")
        err(rzb, wrz, "rz")
        assert torch.equal(pb[frozen], t["p"][frozen])
        assert torch.equal(rzb[frozen], t["rz"][frozen])
        pb2, rzb2 = t["p"].clone(), t["rz"].clone()
        CU.cg_update_b(t["r"], t["z"], pb2, rzb2, act)
        assert torch.equal(pb2, pb) and torch.equal(rzb2, rzb)

        if rehearse is not None:
            rehearse_a, rehearse_b = _rehearsal()
            sub = {k: v[rehearse].cpu() for k, v in t.items()
                   if k != "free"}
            fr = t["free"]
            fr = (fr[rehearse] if fr.dim() == 2 else fr).cpu()
            ra = rehearse_a(*(sub[k] for k in keys), fr, sigma, tol,
                            new_residual)
            for got, w in zip((st["x"], st["r"], st["active"]), ra):
                assert torch.equal(got[rehearse].cpu(), w)
            rb = rehearse_b(sub["r"], sub["z"], sub["p"], sub["rz"],
                            act[rehearse].cpu())
            for got, w in zip((pb, rzb), rb):
                assert torch.equal(got[rehearse].cpu(), w)
        del t, st, again, want
    return {f"err_{k}": v for k, v in worst.items()} | {"froze": froze}


def check_records() -> list:
    """:func:`check` at every shape of :data:`CHECKS`: one record each."""
    import torch

    from cg_mrslam_tpu_torch.ops import cg_update as CU

    out = []
    for lead, n, dt, seed, graphs, rehearse in CHECKS:
        dtype = getattr(torch, dt)
        rec = {"name": f"cg_update_check[{dt} {list(lead)} x {n}]",
               "shape": list(lead) + [n, 3],
               "plan": CU.plan(3 * n)._asdict(),
               "rehearsed": "all" if rehearse is ... else str(rehearse)}
        rec.update(check(lead, n, dtype, seed, graphs, rehearse))
        out.append(rec)
        torch.cuda.empty_cache()
    return out


def shapes(batch: int, star: int) -> list:
    """``(name, lead, n, graphs, new_residual, sigma, dtype name)`` of the
    two cells, the split path and float64."""
    return [(f"fleet_pcg {batch}", (batch,), N, batch, True, 0.0, "float32"),
            (f"star {star} x {COLUMNS}", (star, COLUMNS), N, star, False,
             1e-6, "float32"),
            (f"ring {RING}", (), RING, 1, True, 0.0, "float32"),
            (f"fleet_pcg {batch} float64", (batch,), N, batch, True, 0.0,
             "float64")]


def records(name, lead, n, graphs, new_residual, sigma, dt) -> list:
    import math

    import torch

    from cg_mrslam_tpu_torch.ops import cg_update as CU
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    gen = torch.Generator("cuda").manual_seed(0)
    shape = lead + (n, 3)
    dtype = getattr(torch, dt)
    v = {k: torch.randn(shape, device="cuda", generator=gen, dtype=dtype)
         for k in ("x", "r", "p", "z")}
    v["hp"] = v["p"] * (0.5 + torch.rand(shape, device="cuda",
                                          generator=gen, dtype=dtype))
    rz = torch.rand(lead, device="cuda", generator=gen, dtype=dtype) + 0.5
    active = torch.ones(lead, dtype=torch.bool, device="cuda")
    free = torch.rand((graphs, n), device="cuda", generator=gen) > 0.05
    if not lead:
        free = free[0]
    s = math.prod(lead)
    size = torch.finfo(dtype).bits // 8

    def a():
        CU.cg_update_a(v["x"], v["r"], v["p"], v["hp"], rz, active, free,
                       sigma, 0.0, new_residual)

    def b():
        CU.cg_update_b(v["r"], v["z"], v["p"], rz, active)

    def plain_a():
        CU.update_a_plain(v["x"], v["r"], v["p"], v["hp"], rz, active, free,
                          sigma, 0.0, new_residual)

    def plain_b():
        CU.update_b_plain(v["r"], v["z"], v["p"], rz, active)

    out = []
    for upd, fn, plain in (("a", a, plain_a), ("b", b, plain_b)):
        bound_ms, bound_by = CT.cg_update_bound(s, n, upd, size,
                                                jitter=bool(sigma),
                                                graphs=graphs)
        n_bytes, n_ops = CT.cg_update_work(s, n, upd, size,
                                           jitter=bool(sigma), graphs=graphs)
        rec = {"name": f"cg_update_{upd}[{name}]", "shape": list(shape),
               "plan": CU.plan(3 * n)._asdict(), "ms": CT.event_ms(fn),
               "device_ms": CT.graph_ms(fn), "host_us": CT.host_us(fn),
               "device_ops_per_call": count_device_ops(fn),
               "plain_ms": CT.event_ms(plain, reps=5),
               "plain_device_ops_per_call": count_device_ops(plain),
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": n_bytes,
               "operations": n_ops}
        rec["bound_share"] = bound_ms / rec["device_ms"]
        out.append(rec)
    del v
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="current")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--star", type=int, default=128)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "bench_cg_update.jsonl"))
    args = ap.parse_args()
    import torch

    from cg_mrslam_tpu_torch.ops import cg_update as CU
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    if not torch.cuda.is_available():
        print("bench_cg_update: no CUDA device is available", file=sys.stderr)
        return 2
    card = CT.card_line()
    print(card, f"torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    CU.CG_UPDATE._entries(torch.float32)
    print(f"build and load: {time.perf_counter() - t0:.2f} s", flush=True)
    print(f"ptxas -v:\n{K.ptxas_report(CU.SRC)}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as fh:
        for rec in check_records():
            print(json.dumps(rec), flush=True)
        for shape in shapes(args.batch, args.star):
            for rec in records(*shape):
                rec.update(tag=args.tag, card=card)
                line = json.dumps(rec)
                print(line, flush=True)
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
