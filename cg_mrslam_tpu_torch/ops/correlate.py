"""Correlative scan-match score volumes: kernels K1 and K2 and their plain
version.

Port of ``cg_mrslam_tpu/ops/correlate.py`` (``pallas_score_volume`` and
``pallas_score_volume_strided``, the TPU Pallas kernel ``_make_kernel_v3``).
The work splits in two:

* :func:`volume_cells` — shared torch code: rotate and shift the moving
  points for every (batch entry, θ), take their grid cells, the keep mask
  (valid beam, and not in the same cell as the previous point — reference
  ``chargrid.cpp:242-258``) and the per-θ count ``max(kept, 1)``;
* the gather-sum-divide over a lattice of integer offsets, either by a
  hand-written CUDA kernel of ``csrc/score_volume.cu`` (CUDA tensors only)
  — :data:`SCORE_VOLUME` (K1) for a contiguous ``±ry × ±rx`` window,
  :data:`SCORE_VOLUME_STRIDED` (K2) for a symmetric lattice of stride
  ``sy, sx`` — or by :func:`volume_plain`, plain PyTorch for any lattice
  (both kernels' plain version).

Both sides get identical integer cells, so they differ only in the order
of the float32 sums. One call scores a batch of (grid index, base) pairs —
every region of a keyframe in one launch.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` on first use into
``build/kernels/`` at the repository root, as a shared library with a
plain C interface loaded through ``ctypes``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "score_volume.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# staged cells of one (b, θ) live in 48 KB of default shared memory
MAX_POINTS = 6144


def volume_cells(centers: torch.Tensor, resolution: float, cells: int,
                 points: torch.Tensor, valid: torch.Tensor,
                 bases: torch.Tensor, thetas: torch.Tensor):
    """Cells of every moving point under every candidate rotation.

    ``centers [B,2]``, ``bases [B,3]``, ``valid [B,P]``, ``points [P,2]``
    (shared) or ``[B,P,2]``, ``thetas [T]``. Candidate ``(b, t)`` maps a
    point to ``R(bases[b,2] + thetas[t]) p + bases[b,:2]``. Returns ``(ix,
    iy, keep, count)``: int32 ``[B,T,P]`` cells, bool ``[B,T,P]`` keep mask,
    float32 ``[B,T]`` normalization."""
    if points.dim() == 2:
        points = points[None]
    ang = bases[:, 2:3] + thetas[None, :]                    # [B,T]
    c = torch.cos(ang)[..., None]                            # [B,T,1]
    s = torch.sin(ang)[..., None]
    px = points[:, None, :, 0]                               # [B|1,1,P]
    py = points[:, None, :, 1]
    wx = c * px - s * py + bases[:, 0, None, None]
    wy = s * px + c * py + bases[:, 1, None, None]
    half = cells / 2.0
    ix = torch.floor((wx - centers[:, 0, None, None]) / resolution
                     + half).to(torch.int32)
    iy = torch.floor((wy - centers[:, 1, None, None]) / resolution
                     + half).to(torch.int32)
    # consecutive-duplicate-cell dedup: compared with the previous point
    # whether or not that one is valid; point 0 is never a duplicate
    same = (ix == torch.roll(ix, 1, -1)) & (iy == torch.roll(iy, 1, -1))
    same[..., 0] = False
    keep = valid[:, None, :] & ~same
    count = torch.clamp(keep.sum(-1), min=1).to(torch.float32)
    return ix, iy, keep, count


def volume_plain(grids: torch.Tensor, gidx: torch.Tensor, ix: torch.Tensor,
                 iy: torch.Tensor, keep: torch.Tensor, count: torch.Tensor,
                 ty_cells: torch.Tensor, tx_cells: torch.Tensor
                 ) -> torch.Tensor:
    """Plain PyTorch gather-sum-divide: volumes ``[B,T,Dy,Dx]`` over any
    integer lattice ``ty_cells [Dy]`` × ``tx_cells [Dx]``. Out-of-grid cells
    add 0; the count already includes them. One θ at a time keeps the
    gather at ``[B,P,Dy,Dx]``."""
    n_grids, cells, _ = grids.shape
    flat_grid = grids.reshape(-1)
    ty = ty_cells.to(torch.int64)[None, None, :, None]
    tx = tx_cells.to(torch.int64)[None, None, None, :]
    g0 = (gidx.to(torch.int64) * cells * cells)[:, None, None, None]
    out = []
    for t in range(ix.shape[1]):
        yy = iy[:, t, :, None, None].to(torch.int64) + ty    # [B,P,Dy,1]
        xx = ix[:, t, :, None, None].to(torch.int64) + tx    # [B,P,1,Dx]
        inb = (yy >= 0) & (yy < cells) & (xx >= 0) & (xx < cells)
        idx = (g0 + torch.clamp(yy, 0, cells - 1) * cells
               + torch.clamp(xx, 0, cells - 1))
        v = torch.where(inb, flat_grid[idx],
                        torch.zeros((), device=idx.device))
        w = keep[:, t, :, None, None].to(v.dtype)
        out.append(torch.sum(v * w, dim=1) / count[:, t, None, None])
    return torch.stack(out, dim=1)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the score-volume kernel is "
                           "built from csrc/score_volume.cu on first use")
    return found


def build() -> Path:
    """Compile ``csrc/score_volume.cu`` for ``sm_90a`` into
    ``build/kernels/`` (skipped when a library built from the same source
    is already there). Returns the library's path."""
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    lib = BUILD_DIR / f"libscore_volume-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


_LIB = None


def load_library():
    """Build (once) and load ``csrc/score_volume.cu``; both kernels' entry
    points get their ``ctypes`` signatures."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.cg_score_volume.argtypes = ([ctypes.c_void_p] * 7
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
        lib.cg_score_volume.restype = ctypes.c_int
        lib.cg_score_volume_strided.argtypes = ([ctypes.c_void_p] * 7
                                                + [ctypes.c_int] * 9
                                                + [ctypes.c_void_p])
        lib.cg_score_volume_strided.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_inputs(grids, gidx, ix, iy, keep, count):
    """Device, type, shape and contiguity of a score-volume launch's
    inputs; raises on what the kernel does not take."""
    dev = grids.device
    if dev.type != "cuda":
        raise ValueError("the score-volume kernels take CUDA tensors")
    n_grids, cells, _ = grids.shape
    bsz, n_theta, n_pts = ix.shape
    want = {
        "grids": (grids, torch.float32, (n_grids, cells, cells)),
        "gidx": (gidx, torch.int32, (bsz,)),
        "ix": (ix, torch.int32, (bsz, n_theta, n_pts)),
        "iy": (iy, torch.int32, (bsz, n_theta, n_pts)),
        "keep": (keep, torch.bool, (bsz, n_theta, n_pts)),
        "count": (count, torch.float32, (bsz, n_theta)),
    }
    for name, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dt} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_pts > MAX_POINTS:
        raise ValueError(f"{n_pts} points > {MAX_POINTS}")


class _Counted:
    """Launch counts of one kernel wrapper: :attr:`launches` (one per
    launch, nothing else adds to it) and, in :attr:`launches_by_shape`, per
    output shape ``(B, T, Dy, Dx)`` — for K2 followed by its strides
    ``(sy, sx)``."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_shape = collections.Counter()

    def _launch(self, fn, key, grids, gidx, ix, iy, keep, count, dy, dx,
                *window):
        bsz, n_theta, n_pts = ix.shape
        dev = grids.device
        out = torch.empty((bsz, n_theta, dy, dx), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(grids.data_ptr(), gidx.data_ptr(), ix.data_ptr(),
                iy.data_ptr(), keep.data_ptr(), count.data_ptr(),
                out.data_ptr(), grids.shape[0], bsz, n_theta, n_pts,
                grids.shape[-1], *window, stream)
        if rc != 0:
            raise RuntimeError(f"score-volume kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        self.launches_by_shape[tuple(out.shape) + key] += 1
        return out


class ScoreVolumeKernel(_Counted):
    """K1's wrapper: checks its inputs, allocates the output and launches
    on the current stream over the contiguous window ``±ry × ±rx``."""

    def __call__(self, grids: torch.Tensor, gidx: torch.Tensor,
                 ix: torch.Tensor, iy: torch.Tensor, keep: torch.Tensor,
                 count: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
        _check_inputs(grids, gidx, ix, iy, keep, count)
        if ry < 0 or rx < 0:
            raise ValueError(f"bad window ry={ry} rx={rx}")
        return self._launch(load_library().cg_score_volume, (), grids, gidx,
                            ix, iy, keep, count, 2 * ry + 1, 2 * rx + 1, ry,
                            rx)


class ScoreVolumeStridedKernel(_Counted):
    """K2's wrapper: the strided lattice ``(i - ny)·sy``, ``(j - nx)·sx``
    (``i < 2ny+1``, ``j < 2nx+1``), only its kept offsets computed."""

    def __call__(self, grids: torch.Tensor, gidx: torch.Tensor,
                 ix: torch.Tensor, iy: torch.Tensor, keep: torch.Tensor,
                 count: torch.Tensor, ny: int, nx: int, sy: int,
                 sx: int) -> torch.Tensor:
        _check_inputs(grids, gidx, ix, iy, keep, count)
        if ny < 0 or nx < 0 or sy < 1 or sx < 1:
            raise ValueError(f"bad lattice ny={ny} nx={nx} sy={sy} sx={sx}")
        return self._launch(load_library().cg_score_volume_strided, (sy, sx),
                            grids, gidx, ix, iy, keep, count, 2 * ny + 1,
                            2 * nx + 1, ny, nx, sy, sx)


SCORE_VOLUME = ScoreVolumeKernel()
SCORE_VOLUME_STRIDED = ScoreVolumeStridedKernel()
