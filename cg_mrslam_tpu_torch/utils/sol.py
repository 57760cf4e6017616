"""Speed-of-light accounting of the port's hot paths on an NVIDIA H100.

Port of ``cg_mrslam_tpu/utils/sol.py``. The ceilings are measured on the
same card in the same run (:class:`Ceilings`):

* ``hbm_gbps`` — HBM read bandwidth, from repeated sums over a large
  array (``measure_hbm_peak``);
* ``fp32_matmul_tflops`` — float32 matmul with TF32 off, as the package
  pins it at import (``measure_matmul_peak``);
* ``bf16_tc_tflops`` — BF16 matmul on the tensor cores;
* ``dispatch_s`` — the host's enqueue plus synchronize of a trivial op.

The float32 ceiling outside the tensor cores is not measured: it is the
published 67 TFLOP/s (``utils/metrics.CHIP_PEAKS``), reported as
``fp32_cuda_core_tflops`` and labelled published, where the reference
derives its VPU ceiling from the TPU's architecture.

:func:`account` keeps the reference's arithmetic; its compute units map
the reference's onto the card's: ``mxu_f32`` → ``fp32_matmul``,
``mxu_bf16`` → ``bf16_tc``, ``vpu`` → ``fp32_cuda_core``. One difference:
the reference subtracts its dispatch floor from every time, since it
times a remote round trip on the host; here every time is taken on the
card with CUDA events around the work, so nothing is subtracted, and the
floor is reported as a ceiling of its own (a host floor of K1's size
would send its fraction toward infinity).

Timings are medians over distinct inputs, one per repetition, with CUDA
events around each call (a solve's own host reads and launch gaps
included). K1, a kernel shorter than its host's enqueue, is timed from a
CUDA graph of its calls on the distinct inputs, replayed between events:
device time only, as ``chip_smoke.py``'s ``device_ms``. Off the card
(``device="cpu"``, for tests at small sizes) the host clock times them;
those rows say so and are no device numbers. Run::

    python -m cg_mrslam_tpu_torch.utils.sol [--device cpu --small]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.utils.metrics import CHIP_PEAKS, PEAKS_SOURCE

UNITS = {"fp32_matmul": "fp32_matmul_tflops", "bf16_tc": "bf16_tc_tflops",
         "fp32_cuda_core": "fp32_cuda_core_tflops"}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn: Callable, inputs, dev: torch.device) -> float:
    """Median seconds of ``fn(x)`` over the distinct ``inputs`` after one
    warm-up call: CUDA events around each call on the card (work the call
    waits for on the host included), the host clock elsewhere."""
    fn(inputs[0])
    _sync(dev)
    ts = []
    for x in inputs:
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(x)
            e1.record()
            torch.cuda.synchronize(dev)
            ts.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(x)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass
class Ceilings:
    hbm_gbps: float               # measured GB/s (read)
    bf16_tc_tflops: float         # measured
    fp32_matmul_tflops: float     # measured, TF32 off
    fp32_cuda_core_tflops: float  # published
    dispatch_s: float             # measured host enqueue + synchronize


def measure_dispatch_floor(dev: torch.device, reps: int = 10) -> float:
    """Median host seconds of enqueueing ``x + 1`` and synchronizing, over
    distinct ``x``."""
    xs = [torch.full((1,), float(k), device=dev) for k in range(reps + 1)]
    (xs[0] + 1.0).sum()
    _sync(dev)
    ts = []
    for x in xs[1:]:
        t0 = time.perf_counter()
        x + 1.0
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_hbm_peak(dev: torch.device, mb: int = 512, loops: int = 8,
                     reps: int = 3) -> float:
    """Read bandwidth in GB/s: ``loops`` sums over an ``mb`` MiB array (far
    above the 50 MB L2), a distinct array each repetition."""
    n = mb * 2**20 // 4
    xs = [torch.full((n,), 1.0 + 1e-3 * k, device=dev) for k in range(reps)]

    def body(x):
        acc = torch.zeros((), device=dev)
        for k in range(loops):
            acc = acc + torch.sum(x)
        return acc

    return loops * n * 4 / _timeit(body, xs, dev) / 1e9


def measure_matmul_peak(dev: torch.device, dtype=torch.bfloat16,
                        m: int = 8192, loops: int = 8, reps: int = 3
                        ) -> float:
    """Matmul TFLOP/s of ``loops`` chained ``[m, m]`` products in
    ``dtype`` (float32 runs with TF32 off, as the package pins it), a
    distinct input each repetition."""
    xs = [torch.full((m, m), 1.0 + 1e-3 * k, device=dev, dtype=dtype)
          for k in range(reps)]
    y = torch.full((m, m), 0.5 / m, device=dev, dtype=dtype)

    def body(x):
        s = x
        for _ in range(loops):
            s = s @ y
        return s

    return loops * 2 * m**3 / _timeit(body, xs, dev) / 1e12


def measure_ceilings(dev: torch.device, hbm_mb: int = 512,
                     mm_n: int = 8192) -> Ceilings:
    return Ceilings(
        hbm_gbps=measure_hbm_peak(dev, mb=hbm_mb),
        bf16_tc_tflops=measure_matmul_peak(dev, torch.bfloat16, m=mm_n,
                                           loops=24),
        fp32_matmul_tflops=measure_matmul_peak(dev, torch.float32, m=mm_n),
        fp32_cuda_core_tflops=CHIP_PEAKS["h100_sxm"]["flops"] / 1e12,
        dispatch_s=measure_dispatch_floor(dev))


def account(name: str, seconds: float, bytes_moved: float, flops: float,
            ceilings: Ceilings, unit: str = "fp32_matmul") -> dict:
    """Achieved rates and the fraction of the binding ceiling. ``unit``
    picks the compute ceiling: ``fp32_matmul`` for matmul-shaped float32
    work, ``bf16_tc`` for BF16 tensor-core work, ``fp32_cuda_core`` for
    elementwise and gather kernels such as the score volume. ``seconds``
    is device time: nothing is subtracted."""
    secs = max(seconds, 1e-9)
    gbps = bytes_moved / secs / 1e9
    tflops = flops / secs / 1e12
    peak_t = getattr(ceilings, UNITS[unit])
    frac_bw = gbps / ceilings.hbm_gbps
    frac_fl = tflops / peak_t
    return {
        "kernel": name,
        "device_ms": round(secs * 1e3, 3),
        "achieved_GBps": round(gbps, 1),
        "achieved_TFLOPs": round(tflops, 3),
        "of_hbm_peak": round(frac_bw, 3),
        f"of_{unit}_peak": round(frac_fl, 3),
        "sol_fraction": round(max(frac_bw, frac_fl), 3),
        "bound": "bandwidth" if frac_bw >= frac_fl else "compute",
    }


def _k1_row(dev, ceil, points: int, reps: int) -> dict:
    """K1 at the close-match shape (65 rotations x 25 x 25 offsets, a
    1200-cell grid at 0.025 m), counted with ``chip_smoke.py`` phase 4's
    formula (``cuda_timing.volume_work``)."""
    from cg_mrslam_tpu_torch.matcher.grid import build_grid
    from cg_mrslam_tpu_torch.matcher.search import make_lattice
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.utils.cuda_timing import volume_work

    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-10, 10, (points, 2)).astype(
        np.float32), device=dev)
    pv = torch.ones((points,), dtype=torch.bool, device=dev)
    c0 = torch.zeros((2,), dtype=torch.float32, device=dev)
    grid = build_grid(pts, pv, c0, cells=1200, resolution=0.025,
                      kernel_radius=0.2)
    thetas = make_lattice(0.2, 0.00625, device=dev)
    lat = torch.arange(-12, 13, dtype=torch.int32, device=dev)
    gidx = torch.zeros((1,), dtype=torch.int32, device=dev)
    calls = []
    for k in range(reps + 1):
        base = torch.tensor([[0.1 * k, -0.2, 0.3]], dtype=torch.float32,
                            device=dev)
        calls.append(K.volume_cells(c0[None], 0.025, 1200, pts, pv[None],
                                    base, thetas))
    if dev.type == "cuda":
        from cg_mrslam_tpu_torch.utils.cuda_timing import graph_ms

        def all_calls():
            for c in calls[1:]:
                K.SCORE_VOLUME(grid[None], gidx, *c, 12, 12)

        dt = graph_ms(all_calls, launches=1) / 1e3 / reps
    else:
        dt = _timeit(lambda c: K.volume_plain(grid[None], gidx, *c, lat, lat),
                     calls, dev)
    t, n_off = thetas.shape[0], lat.numel() ** 2
    kept = float(np.mean([int(c[2].sum()) for c in calls]))
    n_bytes, n_ops = volume_work(grid.numel() * 4, 1, t, points, n_off,
                                 t * n_off, kept)
    return account(f"K1 score_volume (close shape {t}x25x25, {points} "
                   f"points)", dt, n_bytes, n_ops, ceil,
                   unit="fp32_cuda_core")


def _perturbed(g, reps: int):
    return [dataclasses.replace(g, poses=g.poses + 1e-4 * k)
            for k in range(1, reps + 1)]


def report(device=None, gn_batch: int = 1024, chain_batch: int = 512,
           chain_n: int = 1024, chain_cg_iters: int = 12,
           k1_points: int = 1024, hbm_mb: int = 512, mm_n: int = 8192,
           reps: int = 4) -> list:
    """The ceilings, then three rows: K1 at the close shape, batched GN x5
    of ``gn_batch`` 64-vertex graphs (dense band, SPD inverse), and the
    chain+Woodbury GN x5 of ``chain_batch`` ``chain_n``-pose hospital
    graphs. Each row names its device."""
    from torch.utils.flop_counter import FlopCounterMode

    from cg_mrslam_tpu_torch.sim.graphs import (build_batch,
                                                build_hospital_batch)
    from cg_mrslam_tpu_torch.solver import chain as CH
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    dev = resolve_device(device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (host clock; no device metric)")
    ceil = measure_ceilings(dev, hbm_mb=hbm_mb, mm_n=mm_n)
    rows = [dict(dataclasses.asdict(ceil), device=where,
                 fp32_cuda_core_source=PEAKS_SOURCE)]

    rows.append(_k1_row(dev, ceil, k1_points, reps))

    g = build_batch(gn_batch, device=dev)
    dt = _timeit(lambda x: gn.optimize(x, 5).poses, _perturbed(g, reps), dev)
    b, n, e = gn_batch, g.poses.shape[1], g.e_ij.shape[1]
    # per GN iteration: the one-hot assembly ≈ 36·N²·E flops and an
    # (3N)³/3 solve; H materialized and refactored, ~3 passes of (3N)² f32
    flops = b * 5 * (36 * n * n * e + (3 * n) ** 3 / 3)
    bytes_m = b * 5 * ((3 * n) ** 2 * 4 * 3)
    rows.append(account(f"batched GN x5 ({gn_batch} graphs, dense)", dt,
                        bytes_m, flops, ceil, unit="fp32_matmul"))

    g = build_hospital_batch(chain_batch, n=chain_n, device=dev)

    def chain(x):
        return CH.optimize_chain(x, iterations=5, loop_cap=64,
                                 cg_iters=chain_cg_iters).poses

    dt = _timeit(chain, _perturbed(g, reps), dev)
    with FlopCounterMode(display=False) as fc:
        chain(g)
    flops = fc.get_total_flops()
    # bytes by hand, a lower bound: per GN iteration the graph read once
    # and its poses written once, and the Woodbury factor Hc⁻¹U [B,N,3,3M]
    # written once and read once
    b, n, e = chain_batch, chain_n, g.e_ij.shape[1]
    m = 64
    graph_bytes = b * (n * 3 * 4 * 2 + n * 2 + e * (2 * 4 + 3 * 4 + 6 * 4 + 1))
    bytes_m = 5 * (graph_bytes + 2 * b * n * 3 * 3 * m * 4)
    rows.append(account(
        f"chain+Woodbury GN x5 ({chain_batch} x {chain_n}-pose, cg "
        f"{chain_cg_iters}; flops: FlopCounterMode, matmul-class only; "
        f"bytes counted by hand -> lower bound)", dt, bytes_m, flops, ceil,
        unit="fp32_matmul"))
    for r in rows[1:]:
        r["device"] = where
        if dev.type != "cuda":    # a host time, not a device metric
            r["host_ms"] = r.pop("device_ms")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--small", action="store_true",
                    help="small sizes (a quick run off the card)")
    a = ap.parse_args(argv)
    kw = (dict(gn_batch=4, chain_batch=2, chain_n=64, k1_points=256,
               hbm_mb=8, mm_n=256, reps=2) if a.small else {})
    for row in report(a.device, **kw):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
