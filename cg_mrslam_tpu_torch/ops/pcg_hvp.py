"""The PCG band's Hessian-vector product as a hand-written CUDA kernel pair
(``csrc/pcg_hvp.cu``): one pass over the edges, one fixed-order pass over
the vertices.

:data:`PCG_HVP` computes, for CUDA tensors, what ``solver/pcg.py``'s plain
version ``_hvp_plain`` computes: ``y = free · Σ Jᵀ(Ω(J x))`` over each
vertex's edge ends, summed in the order of the solve's segment table
(``solver/fixed_sum.py``), walked in its compressed-row form. It takes one
graph or a batch (``e_ij [*B, E, 2]``) and any column axes between the
batch and the vertices (``x [*B, *C, N, 3]``). The source is built by
``ops/correlate.build`` (``nvcc``, ``sm_90a``, ``build/kernels/``) and
loaded on the first launch, so a process that never reaches the PCG band
neither builds nor loads it.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from cg_mrslam_tpu_torch.ops.correlate import build

SRC = Path(__file__).resolve().parents[1] / "csrc" / "pcg_hvp.cu"
# the kernels index threads and compressed-row entries in 32 bits, with
# room for a grid-stride step
MAX_ITEMS = 1 << 30

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {torch.float32: "cg_pcg_hvp_f32", torch.float64: "cg_pcg_hvp_f64"}


class PcgHvpKernel:
    """The kernel pair's wrapper: checks its inputs, allocates the output
    and the edge pass's scratch, and launches both passes on the current
    stream. :attr:`launches` counts calls (one per pair)."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def _entry(self, dtype: torch.dtype):
        if self._lib is None:
            lib = ctypes.CDLL(str(build(SRC)))
            for name in _ENTRIES.values():
                fn = getattr(lib, name)
                fn.argtypes = ([_PTR] * 10 + [_INT] * 7 + [_LONG] * 4
                               + [_PTR])
                fn.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, _ENTRIES[dtype])

    def __call__(self, e_ij: torch.Tensor, Ji: torch.Tensor, Jj: torch.Tensor,
                 omega: torch.Tensor, entries: torch.Tensor,
                 offsets: torch.Tensor, free: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError("the PCG Hessian-vector kernel takes CUDA "
                             "tensors")
        b, c, n, e = check_inputs(e_ij, Ji, Jj, omega, entries, offsets,
                                  free, x)
        # e_ij and x may be strided (the batch builders and the slot
        # permutation leave e_ij so; a caller may hand a strided
        # direction): the kernel reads both at their strides, with no copy
        sb = e_ij.stride(0) if e_ij.dim() == 3 else 0
        se, sk = e_ij.stride(-2), e_ij.stride(-1)
        xs = x.view(b, c, n, 3).stride()
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        contrib = torch.empty((2 * b * e, c, 3), dtype=x.dtype,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = self._entry(x.dtype)(
            e_ij.data_ptr(), Ji.data_ptr(), Jj.data_ptr(), omega.data_ptr(),
            entries.data_ptr(), offsets.data_ptr(), free.data_ptr(),
            x.data_ptr(), contrib.data_ptr(), y.data_ptr(), b, c, n, e, sb,
            se, sk, *xs, stream)
        if rc != 0:
            raise RuntimeError(f"PCG Hessian-vector kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return y


def check_inputs(e_ij: torch.Tensor, Ji: torch.Tensor, Jj: torch.Tensor,
                 omega: torch.Tensor, entries: torch.Tensor,
                 offsets: torch.Tensor, free: torch.Tensor,
                 x: torch.Tensor) -> tuple:
    """Types, shapes, devices and layouts of a launch's inputs (one
    graph, ``e_ij [E, 2]``, or a batch, ``[B, E, 2]``; ``x [*B, *C, N,
    3]``): ``e_ij`` and ``x`` at any strides (``x``'s column axes must
    merge into one without a copy), the rest contiguous. Raises
    ``ValueError`` on what the kernels do not take. Returns the sizes
    ``(B, C, N, E)`` the kernels see."""
    nb = e_ij.dim() - 2
    if nb not in (0, 1):
        raise ValueError(f"e_ij: want [E, 2] or [B, E, 2], got "
                         f"{tuple(e_ij.shape)}")
    if x.dim() < nb + 2:
        raise ValueError(f"x: want [*B, *C, N, 3], got {tuple(x.shape)}")
    b = e_ij.shape[0] if nb else 1
    e = e_ij.shape[-2]
    n = x.shape[-2]
    c = math.prod(x.shape[nb:-2])
    dt = x.dtype
    if dt not in _ENTRIES:
        raise ValueError(f"x: want float32 or float64, got {dt}")
    lead = tuple(e_ij.shape[:nb])
    want = {
        "e_ij": (e_ij, torch.int32, lead + (e, 2)),
        "Ji": (Ji, dt, lead + (e, 3, 3)),
        "Jj": (Jj, dt, lead + (e, 3, 3)),
        "omega": (omega, dt, lead + (e, 3, 3)),
        "entries": (entries, torch.int32, (2 * b * e,)),
        "offsets": (offsets, torch.int32, (b * n + 1,)),
        "free": (free, torch.bool, lead + (n,)),
        "x": (x, dt, lead + tuple(x.shape[nb:-2]) + (n, 3)),
    }
    for name, (t, tdt, shape) in want.items():
        if t.device != x.device or t.dtype != tdt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {tdt} {shape} on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        if name not in ("e_ij", "x") and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    try:
        x.view(b, c, n, 3)
    except RuntimeError as err:
        raise ValueError(f"x: its column axes do not merge into one "
                         f"({tuple(x.shape)} at {x.stride()})") from err
    if max(b * e * c, b * c * n, 2 * b * e) >= MAX_ITEMS:
        raise ValueError(f"too large for 32-bit indices: B {b}, C {c}, "
                         f"N {n}, E {e}")
    return b, c, n, e


PCG_HVP = PcgHvpKernel()
