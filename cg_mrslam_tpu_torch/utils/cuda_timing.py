"""Measurement helpers for the kernel records of ``chip_smoke.py`` and
``tools/bench_score_volume.py`` (and ``tools/bench_pcg_hvp.py``): one
CUDA launch timed three ways, the card's line, and the kernels' bounds.

* :func:`event_ms` — CUDA events around ``reps`` back-to-back calls after
  warm-up: device time plus whatever the host's enqueue adds when it is
  slower than the kernel.
* :func:`graph_ms` — ``launches`` calls captured once into a CUDA graph,
  the graph replayed ``replays`` times between CUDA events: device time
  only (the CUDA driver enqueues the launches of a graph, not the host).
* :func:`host_us` — the host clock per call over ``calls`` calls with no
  synchronization inside: the enqueue cost a host-bound caller pays.
* :func:`volume_bound` — the least time of one score-volume call on an
  H100 SXM (bytes over the HBM rate, operations over the float32 rate);
  :func:`hvp_bound` the same for one Hessian-vector product of the PCG
  band (:func:`hvp_scratch_bytes`: what its kernel pair's split adds),
  :func:`cr_apply_bound` of its preconditioner's solve and
  :func:`cg_update_bound` of one of its CG loop's vector updates;
  :func:`issue_floor_ms` — the gather design's issue floor at a given SM
  clock. All are computed, not measured.

``fn`` is a callable that launches on the current stream and allocates
only through torch (allowed under graph capture).
"""

from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# the gather design's issue floor: one 4-byte load per (point, offset), at
# most one warp-wide load (32 lanes) issued per clock on each of 132 SMs
SMS, LOADS_PER_CLOCK = 132, 32


def _smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return _smi("name,power.limit")


def max_sm_clock_ghz() -> float:
    """The card's maximum SM clock as nvidia-smi reads it (not the clock
    it ran at), in GHz."""
    return float(_smi("clocks.max.sm").split()[0]) / 1e3


def issue_floor_ms(loads: int, ghz: float) -> float:
    """``loads`` warp-lane loads at 32 a clock on each of 132 SMs."""
    return loads / (SMS * LOADS_PER_CLOCK * ghz * 1e9) * 1e3


def volume_work(grid_bytes: int, b: int, t: int, p: int, n_off: int,
                n_out: int, n_kept: int):
    """``(bytes, operations)`` of one score-volume call: the function's
    own inputs, each read once — the grids it scores (``grid_bytes``),
    points [P,2] f32, valid [B,P] bool, bases [B,3] f32, thetas [T] f32 —
    and its ``n_out`` output values written once; its adds (kept points x
    offsets per output volume) and divides. The cells, keep mask and count
    are intermediates of the split between torch code and the kernel."""
    n_bytes = grid_bytes + p * 2 * 4 + b * p + b * 3 * 4 + t * 4 + n_out * 4
    n_ops = n_kept * n_off * (n_out // (b * t * n_off)) + n_out
    return n_bytes, n_ops


def volume_bound(grid_bytes: int, b: int, t: int, p: int, n_off: int,
                 n_out: int, n_kept: int):
    """``(bound_ms, bound_by)`` of one score-volume call: its
    :func:`volume_work` bytes over the HBM rate against its operations
    over the float32 rate."""
    n_bytes, n_ops = volume_work(grid_bytes, b, t, p, n_off, n_out, n_kept)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def hvp_work(b: int, c: int, n: int, e: int, listed: int,
             itemsize: int = 4):
    """``(bytes, operations)`` of one Hessian-vector product of the PCG
    band over ``b`` graphs, ``c`` columns, ``n`` vertex and ``e`` edge
    slots with ``listed`` active edge ends: the function's own inputs,
    each read once — Jᵢ, Jⱼ, Ω, the edges' int32 ends, ``x``, the int32
    compressed rows (their listed entries and the offsets) and the bool
    ``free`` — and ``y`` written once; 78 operations a (edge, column)
    (five 3×3 products and a vector add), an add a listed (end, column)
    component and the ``free`` product. The edge ends' 3-vectors are an
    intermediate of the two-pass design (:func:`hvp_scratch_bytes`)."""
    s = itemsize
    n_bytes = (3 * b * e * 9 * s + b * e * 2 * 4 + 2 * b * c * n * 3 * s
               + listed * 4 + (b * n + 1) * 4 + b * n)
    n_ops = 78 * b * e * c + 3 * listed * c + 3 * b * c * n
    return n_bytes, n_ops


def hvp_scratch_bytes(b: int, c: int, e: int, listed: int,
                      itemsize: int = 4) -> int:
    """The bytes the kernel pair's split adds to :func:`hvp_work`'s: the
    edge pass writes one 3-vector a (edge end, column) and the vertex
    pass reads the listed ones back."""
    return 2 * b * e * c * 3 * itemsize + listed * c * 3 * itemsize


def hvp_bound(b: int, c: int, n: int, e: int, listed: int,
              itemsize: int = 4):
    """``(bound_ms, bound_by)`` of one Hessian-vector product of the PCG
    band: its :func:`hvp_work` bytes over the HBM rate against its
    operations over the float32 rate."""
    n_bytes, n_ops = hvp_work(b, c, n, e, listed, itemsize)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def cr_apply_work(b: int, c: int, n: int, m: int, itemsize: int = 4):
    """``(bytes, operations)`` of one solve of the cyclic-reduction
    preconditioner over ``b`` graphs, ``c`` columns and ``n`` poses, the
    factor over ``m`` super-blocks of 48 rows: the compact factor read
    once (``ops/cr_apply.layout``: per odd super-block ``D⁻¹``, 3×48 rows
    of ``A`` and ``B``, two 3×3 corners; the root inverse), the bool
    ``free``, ``r`` read once and ``z`` written once; per column 2 × 48 × 48
    operations a ``D⁻¹`` and the root, 2 × 6 × 48 a pair's forward rows, 2 ×
    18 its corners."""
    from cg_mrslam_tpu_torch.ops.cr_apply import layout

    s = itemsize
    n_bytes = (b * layout(m, 16).size * s + b * n
               + 2 * b * c * n * 3 * s)
    n_ops = 2 * b * c * ((m - 1) * (48 * 48 + 6 * 48 + 18) + 48 * 48)
    return n_bytes, n_ops


def cr_apply_bound(b: int, c: int, n: int, m: int, itemsize: int = 4):
    """``(bound_ms, bound_by)`` of one solve: :func:`cr_apply_work`'s
    bytes over the HBM rate against its operations over the float32
    rate."""
    n_bytes, n_ops = cr_apply_work(b, c, n, m, itemsize)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def cg_update_work(s: int, n: int, update: str, itemsize: int = 4,
                   jitter: bool = False, graphs: int = 1):
    """``(bytes, operations)`` of one CG update (``ops/cg_update.py``) over
    ``s`` active systems of ``n`` poses (``3n`` floats): its own inputs,
    each read once, and outputs, each written once. Update ``"a"`` reads
    ``p``, ``hp``, ``r``, ``x``, ``rz``, the flags (and, with the jitter,
    ``graphs`` rows of ``free``) and writes ``x``, ``r``: 2 operations
    an element a dot product (two: ``p·hps``, one of the residuals), 2
    for ``r₂``, 2 for ``x`` (and 3 for the jitter). Update ``"b"`` reads
    ``r``, ``z``, ``p``, ``rz``, the flags and writes ``p``, ``rz``: 2
    for ``r·z`` and 2 for ``p``."""
    el = s * 3 * n
    if update == "a":
        n_bytes = (6 * el * itemsize + s * (itemsize + 2)
                   + (graphs * n if jitter else 0))
        return n_bytes, (8 + 3 * jitter) * el
    return 4 * el * itemsize + s * (2 * itemsize + 1), 4 * el


def cg_update_bound(s: int, n: int, update: str, itemsize: int = 4,
                    jitter: bool = False, graphs: int = 1):
    """``(bound_ms, bound_by)`` of one CG update: :func:`cg_update_work`'s
    bytes over the HBM rate against its operations over the float32
    rate."""
    n_bytes, n_ops = cg_update_work(s, n, update, itemsize, jitter, graphs)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (launches * replays)
    del graph
    return ms


def host_us(fn, calls: int = 200) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6
