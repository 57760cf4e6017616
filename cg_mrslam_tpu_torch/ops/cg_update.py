"""The PCG loop's vector updates as two hand-written CUDA kernels a CG
iteration (``csrc/cg_update.cu``), and their plain version.

One CG iteration of ``solver/pcg.py:_masked_pcg`` is ``hp = H p`` (the HVP
kernel pair), update A, ``z = M⁻¹ r`` (the preconditioner's kernel) and
update B:

* **A**, per active system: ``hps = hp + σ·free·p`` (σ the marginal
  columns' jitter, 0 in the GN step), ``α = rz / max(p·hps, 1e-30)``,
  ``r₂ = r − α hps``, ``done`` from ``r₂·r₂ < tol`` (``new_residual``) or
  ``r·r < tol``; a system that is not done takes ``x += α p``, ``r = r₂``,
  one that is done only clears its ``active`` flag;
* **B**, per active system: ``rz₂ = r·z``, ``β = rz₂ / max(rz, 1e-30)``,
  ``p = z + β p``, ``rz = rz₂``.

A system is a graph (``[B]``) or one column of a graph's marginal solves
(``[B, C]``): the vectors are ``[*S, N, 3]``, ``rz`` and ``active``
``[*S]``, ``free`` ``[N]`` or ``[B, N]``. A system that is not active is
left as it is: its state no longer changes, so its ``done`` test would
pass again on every later iteration, and skipping it is exactly the
plain loop's select.

:func:`cg_update_a` and :func:`cg_update_b` launch the kernels for CUDA
tensors (:data:`CG_UPDATE`, in place: they return the tensors they were
given) and run :func:`update_a_plain` / :func:`update_b_plain` for CPU
tensors (new tensors: the CG body's arithmetic as the loop did it before
the kernels, in its order, so the CPU keeps its bits). The kernels' dot
products sum in another, fixed order (:func:`plan`), so the card's
iterates differ from the CPU's in their last bits and repeat bit for bit.
The source is built by ``ops/correlate.build`` (``nvcc``, ``sm_90a``,
``build/kernels/``) and loaded on the first launch.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.ops.correlate import build
from cg_mrslam_tpu_torch.solver.spd import per

SRC = Path(__file__).resolve().parents[1] / "csrc" / "cg_update.cu"
# a block's threads, and the items a thread holds of each vector (one
# template instance each: 8 for the 512-slot buckets, 12 for the 1024-slot
# ones); a system longer than THREADS × ITEMS[-1] floats splits into
# chunks of that many, one block each
THREADS = 256
ITEMS = (8, 12)
CHUNK = THREADS * ITEMS[-1]
# the kernels count blocks in 32 bits
MAX_BLOCKS = (1 << 31) - 1
# the floor of the quotients' denominators, as the plain loop clamps them
FLOOR = 1e-30

_PTR, _INT, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_ENTRIES = {torch.float32: ("cg_update_a_f32", "cg_update_b_f32"),
            torch.float64: ("cg_update_a_f64", "cg_update_b_f64")}


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each system's dot product of ``[..., N, 3]`` vectors."""
    return torch.sum(a * b, dim=(-2, -1))


def free_mask(free: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``free [..., N]`` as a float mask broadcasting against ``like
    [..., *C, N, 3]`` (a batch's graph axis first)."""
    fb = free[..., None].to(like.dtype)
    if free.dim() == 2:
        fb = fb.reshape((fb.shape[0],) + (1,) * (like.dim() - 3)
                        + fb.shape[1:])
    return fb


def update_a_plain(x, r, p, hp, rz, active, free, sigma: float, tol: float,
                   new_residual: bool):
    """Update A in plain PyTorch: new ``(x, r, active)``."""
    if sigma:
        hp = hp + sigma * p * free_mask(free, p)
    alpha = rz / torch.clamp(dot(p, hp), min=FLOOR)
    x2 = x + per(alpha, p) * p
    r2 = r - per(alpha, hp) * hp
    rt = r2 if new_residual else r
    done = (dot(rt, rt) < tol) | ~active
    return (torch.where(per(done, x), x, x2),
            torch.where(per(done, r), r, r2), ~done)


def update_b_plain(r, z, p, rz, active):
    """Update B in plain PyTorch: new ``(p, rz)``."""
    rz2 = dot(r, z)
    beta = rz2 / torch.clamp(rz, min=FLOOR)
    p2 = z + per(beta, p) * p
    return torch.where(per(active, p), p2, p), torch.where(active, rz2, rz)


class Plan(NamedTuple):
    """A launch's shape: ``items`` a thread of each vector, ``chunks``
    blocks a system (1: the block holds the whole system)."""
    items: int
    chunks: int


def plan(length: int) -> Plan:
    """From a system's ``length`` (3N floats): one block a system, with
    the fewest items a thread that hold it, up to :data:`CHUNK` floats
    (the benchmark's 1024-slot graphs: 3072, twelve a thread); a longer
    system in chunks of :data:`CHUNK`, one block each, its sums two-stage
    (the blocks' partials, then their ordered sum)."""
    if length <= CHUNK:
        need = -(-length // THREADS)
        return Plan(next(k for k in ITEMS if k >= need), 1)
    return Plan(ITEMS[-1], -(-length // CHUNK))


class Sizes(NamedTuple):
    systems: int
    length: int
    columns: int       # systems a graph
    vertices: int


def check_inputs(vectors: dict, rz: torch.Tensor, active: torch.Tensor,
                 free: torch.Tensor | None) -> Sizes:
    """Types, shapes, devices and layouts of a launch's inputs: every
    vector ``[*S, N, 3]`` float32 or float64, contiguous, on one CUDA
    device; ``rz`` ``[*S]`` of their type and ``active`` ``[*S]`` bool,
    contiguous; ``free`` None or bool ``[N]`` / ``[B, N]`` contiguous,
    ``B`` leading ``*S``. Raises ``ValueError`` on what the kernels do not
    take."""
    name, v = next(iter(vectors.items()))
    if v.device.type != "cuda":
        raise ValueError("the CG update kernels take CUDA tensors")
    if v.dim() < 2 or v.shape[-1] != 3:
        raise ValueError(f"{name}: want [*S, N, 3], got {tuple(v.shape)}")
    dt = v.dtype
    if dt not in _ENTRIES:
        raise ValueError(f"{name}: want float32 or float64, got {dt}")
    lead = tuple(v.shape[:-2])
    want = {k: (t, dt, tuple(v.shape)) for k, t in vectors.items()}
    want.update(rz=(rz, dt, lead), active=(active, torch.bool, lead))
    for k, (t, tdt, shape) in want.items():
        if t.device != v.device or t.dtype != tdt or tuple(t.shape) != shape:
            raise ValueError(f"{k}: want {tdt} {shape} on {v.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")
    s, n = math.prod(lead), v.shape[-2]
    b = 1
    if free is not None:
        if (free.device != v.device or free.dtype != torch.bool
                or free.dim() not in (1, 2) or free.shape[-1] != n
                or (free.dim() == 2 and lead[:1] != free.shape[:1])
                or not free.is_contiguous()):
            raise ValueError(f"free: want contiguous torch.bool [N] or "
                             f"[B, N] (N {n}, B leading {lead}) on "
                             f"{v.device}, got {free.dtype} "
                             f"{tuple(free.shape)} on {free.device}")
        b = free.shape[0] if free.dim() == 2 else 1
    if s * plan(3 * n).chunks > MAX_BLOCKS:
        raise ValueError(f"too many blocks for the grid: {s} systems of "
                         f"{3 * n} floats")
    return Sizes(s, 3 * n, max(s // b, 1), n)


class CgUpdateKernel:
    """The kernels' wrapper: checks the inputs, allocates a split
    system's scratch and launches on the current stream. :attr:`launches`
    counts calls (one an update, whatever the launches it takes)."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def _entries(self, dtype: torch.dtype):
        if self._lib is None:
            lib = ctypes.CDLL(str(build(SRC)))
            for a, b in _ENTRIES.values():
                fa, fb = getattr(lib, a), getattr(lib, b)
                fa.argtypes = [_PTR] * 9 + [_DBL] * 2 + [_INT] * 7 + [_PTR]
                fb.argtypes = [_PTR] * 6 + [_INT] * 4 + [_PTR]
                fa.restype = fb.restype = ctypes.c_int
            self._lib = lib
        a, b = _ENTRIES[dtype]
        return getattr(self._lib, a), getattr(self._lib, b)

    def update_a(self, x, r, p, hp, rz, active, free, sigma: float,
                 tol: float, new_residual: bool) -> None:
        """Update A in place (``free`` read only where ``sigma``)."""
        fr = free if sigma else None
        sz = check_inputs({"x": x, "r": r, "p": p, "hp": hp}, rz, active, fr)
        pl = plan(sz.length)
        part = skip = None
        if pl.chunks > 1:
            part = torch.empty(sz.systems * pl.chunks * 2, dtype=x.dtype,
                               device=x.device)
            skip = torch.empty(sz.systems, dtype=torch.uint8, device=x.device)
        fn = self._entries(x.dtype)[0]
        rc = fn(x.data_ptr(), r.data_ptr(), p.data_ptr(), hp.data_ptr(),
                rz.data_ptr(), active.data_ptr(),
                None if fr is None else fr.data_ptr(),
                None if part is None else part.data_ptr(),
                None if skip is None else skip.data_ptr(), float(sigma),
                float(tol), sz.systems, sz.length, sz.columns, sz.vertices,
                int(new_residual), pl.items, pl.chunks,
                torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CG update A launch failed: cudaError {rc}")
        self.launches += 1

    def update_b(self, r, z, p, rz, active) -> None:
        """Update B in place."""
        sz = check_inputs({"r": r, "z": z, "p": p}, rz, active, None)
        pl = plan(sz.length)
        partb = (torch.empty(sz.systems * pl.chunks, dtype=r.dtype,
                             device=r.device) if pl.chunks > 1 else None)
        fn = self._entries(r.dtype)[1]
        rc = fn(r.data_ptr(), z.data_ptr(), p.data_ptr(), rz.data_ptr(),
                active.data_ptr(), None if partb is None else partb.data_ptr(),
                sz.systems, sz.length, pl.items, pl.chunks,
                torch.cuda.current_stream(r.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CG update B launch failed: cudaError {rc}")
        self.launches += 1


CG_UPDATE = CgUpdateKernel()


def cg_update_a(x, r, p, hp, rz, active, free, sigma: float, tol: float,
                new_residual: bool):
    """Update A: ``(x, r, active)``, on the card updated in place by the
    kernel, on the CPU new (:func:`update_a_plain`)."""
    if x.is_cuda:
        CG_UPDATE.update_a(x, r, p, hp, rz, active, free, sigma, tol,
                           new_residual)
        return x, r, active
    return update_a_plain(x, r, p, hp, rz, active, free, sigma, tol,
                          new_residual)


def cg_update_b(r, z, p, rz, active):
    """Update B: ``(p, rz)``, on the card updated in place by the kernel,
    on the CPU new (:func:`update_b_plain`)."""
    if r.is_cuda:
        CG_UPDATE.update_b(r, z, p, rz, active)
        return p, rz
    return update_b_plain(r, z, p, rz, active)
