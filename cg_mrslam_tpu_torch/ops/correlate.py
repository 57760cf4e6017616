"""Correlative scan-match score volumes: kernels K1 and K2, K2's fused
``known_cap`` pair, two timing probes, and their plain versions.

Port of ``cg_mrslam_tpu/ops/correlate.py`` (``pallas_score_volume`` and
``pallas_score_volume_strided``, the TPU Pallas kernel ``_make_kernel_v3``;
the probes stand for its ``_make_kernel_x1`` / ``_x2``). The work splits in
two:

* :func:`volume_cells` — shared torch code: rotate and shift the moving
  points for every (batch entry, θ), take their grid cells, the keep mask
  (valid beam, and not in the same cell as the previous point — reference
  ``chargrid.cpp:242-258``) and the per-θ count ``max(kept, 1)``;
* the gather-sum-divide over a lattice of integer offsets, either by a
  hand-written CUDA kernel of ``csrc/score_volume.cu`` (CUDA tensors only)
  — :data:`SCORE_VOLUME` (K1) for a contiguous ``±ry × ±rx`` window,
  :data:`SCORE_VOLUME_STRIDED` (K2) for a symmetric lattice of stride
  ``sy, sx``, which with ``known_cap`` scores the pair ``grid·known``,
  ``known`` in one pass — or by :func:`volume_plain` /
  :func:`volume_pair_plain`, plain PyTorch for any lattice.

Both sides get identical integer cells, so they differ only in the order
of the float32 sums. One call scores a batch of (grid index, base) pairs —
every region of a keyframe in one launch. :data:`PROBE_NO_GATHER` and
:data:`PROBE_CONST_CELLS` time the kernel's body without its gathers;
their results are wrong by design (:func:`probe_plain` says what they
compute) and the main path never launches them.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` on first use into
``build/kernels/`` at the repository root, as a shared library with a
plain C interface loaded through ``ctypes`` (:func:`build`, which the
PCG band's kernel pair, ``ops/pcg_hvp.py``, shares).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from cg_mrslam_tpu_torch.matcher.grid import over
from cg_mrslam_tpu_torch.utils.se2 import cos_sin

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
    c, s = cos_sin(ang)
    c, s = c[..., None], s[..., None]                        # [B,T,1]
    px = points[:, None, :, 0]                               # [B|1,1,P]
    py = points[:, None, :, 1]
    wx = c * px - s * py + bases[:, 0, None, None]
    wy = s * px + c * py + bases[:, 1, None, None]
    half = cells / 2.0
    # the card's cells equal the CPU's (see matcher.grid.over)
    ix = torch.floor(over(wx - centers[:, 0, None, None], resolution)
                     + half).to(torch.int32)
    iy = torch.floor(over(wy - centers[:, 1, None, None], resolution)
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


def volume_pair_plain(grids: torch.Tensor, gidx: torch.Tensor,
                      ix: torch.Tensor, iy: torch.Tensor, keep: torch.Tensor,
                      count: torch.Tensor, ty_cells: torch.Tensor,
                      tx_cells: torch.Tensor, known_cap: float
                      ) -> torch.Tensor:
    """K2's ``known_cap`` pair, plain: ``[B, 2, T, Dy, Dx]``, the volumes of
    ``grid·known`` and of ``known`` (``known = grid < known_cap``) for
    every (grid index, cells) pair — :func:`volume_plain` over the two grids
    of :func:`stack_pair`, as the reference scores them."""
    vol = volume_plain(*stack_pair(grids, gidx, ix, iy, keep, count,
                                   known_cap), ty_cells, tx_cells)
    return vol.reshape((ix.shape[0], 2) + vol.shape[1:])


def stack_pair(grids: torch.Tensor, gidx: torch.Tensor, ix: torch.Tensor,
               iy: torch.Tensor, keep: torch.Tensor, count: torch.Tensor,
               known_cap: float) -> tuple:
    """The ``known_cap`` pair as two grids: ``(grids2, gidx2, ix2, iy2,
    keep2, count2)`` — grid ``2g`` is ``grids[g]·known``, grid ``2g+1`` is
    ``known`` (``grids[g] < known_cap``), and every search is repeated,
    search ``2b`` on the first, ``2b+1`` on the second."""
    cells = grids.shape[-1]
    known = (grids < known_cap).to(grids.dtype)
    stacked = torch.stack([grids * known, known], 1).reshape(-1, cells,
                                                             cells)
    g2 = torch.stack([2 * gidx, 2 * gidx + 1], 1).reshape(-1)
    return (stacked, g2) + tuple(torch.repeat_interleave(t, 2, dim=0)
                                 for t in (ix, iy, keep, count))


def probe_plain(mode: str, grids: torch.Tensor, gidx: torch.Tensor,
                ix: torch.Tensor, iy: torch.Tensor, keep: torch.Tensor,
                count: torch.Tensor, ty_cells: torch.Tensor,
                tx_cells: torch.Tensor) -> torch.Tensor:
    """What a timing probe (:class:`ScoreVolumeProbe`) computes, plain:
    ``"no_gather"`` scores a grid whose cell ``y·C + x`` holds the float32
    with the bits ``(y·C + x) | 0x3f800000`` (a value in [1, 2) for a grid
    under 2896² cells); ``"const_cells"`` stages every point, kept or not,
    at cell ``(C/2, C/2)``. Neither is a score volume."""
    cells = grids.shape[-1]
    if mode == "no_gather":
        index = (torch.arange(cells * cells, dtype=torch.int32,
                              device=grids.device) | 0x3F800000)
        index = index.view(torch.float32).reshape(1, cells, cells)
        return volume_plain(index, torch.zeros_like(gidx), ix, iy, keep,
                            count, ty_cells, tx_cells)
    if mode == "const_cells":
        mid = torch.full_like(ix, cells // 2)
        return volume_plain(grids, gidx, mid, mid, torch.ones_like(keep),
                            count, ty_cells, tx_cells)
    raise ValueError(f"unknown probe {mode!r}")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ on first use")
    return found


def build(src: Path = _SRC) -> Path:
    """Compile a CUDA source with a plain C interface (by default
    ``csrc/score_volume.cu``) for ``sm_90a`` into ``build/kernels/`` as
    ``lib<stem>-<sha1>.so``, skipped when a library built from the same
    bytes is already there. ``ptxas``'s report (registers, shared memory,
    spills of each kernel) is kept beside the library as
    ``<library>.ptxas.txt``. Returns the library's path."""
    text = Path(src).read_bytes()
    tag = hashlib.sha1(text).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{Path(src).stem}-{tag}.so"
    if lib.exists() and Path(f"{lib}.ptxas.txt").exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o",
           tmp, str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        Path(f"{lib}.ptxas.txt").write_text(res.stdout + res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def ptxas_report(src: Path = _SRC) -> str:
    """``ptxas -v``'s report of the library built from ``src`` (built
    here if it is not yet)."""
    return Path(f"{build(src)}.ptxas.txt").read_text()


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types: 7 pointers (grids, gidx, ix, iy, keep,
# count, out), the sizes (n_grids, B, T, P, C), the lattice, the stream
_SIGNATURES = {
    "cg_score_volume": [_PTR] * 7 + [_INT] * 7 + [_PTR],
    "cg_score_volume_strided": [_PTR] * 7 + [_INT] * 9 + [_PTR],
    "cg_score_volume_pair": ([_PTR] * 7 + [_INT] * 9 + [ctypes.c_float]
                             + [_PTR]),
    "cg_score_volume_probe": [_INT] + [_PTR] * 7 + [_INT] * 9 + [_PTR],
}
_LIBS = {}


def load_library(src: Path = _SRC):
    """Build (once) and load a score-volume source; every entry point it
    has gets its ``ctypes`` signature. Another source (an earlier version
    of the kernel, for a comparison in one process) loads beside it.
    Every launch asks for its library here: a loaded one is found by the
    path as given, with no file-system call."""
    key = str(src)
    if key not in _LIBS:
        lib = ctypes.CDLL(str(build(src)))
        for name, argtypes in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]


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


def launch(fn, grids, gidx, ix, iy, keep, count, out_shape, *window):
    """One launch of the ``ctypes`` entry point ``fn`` on the current
    stream into a new float32 output ``out_shape``: no input check and no
    count (the wrappers below add both)."""
    bsz, n_theta, n_pts = ix.shape
    dev = grids.device
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(grids.data_ptr(), gidx.data_ptr(), ix.data_ptr(), iy.data_ptr(),
            keep.data_ptr(), count.data_ptr(), out.data_ptr(),
            grids.shape[0], bsz, n_theta, n_pts, grids.shape[-1], *window,
            stream)
    if rc != 0:
        raise RuntimeError(f"score-volume kernel launch failed: "
                           f"cudaError {rc}")
    return out


def _check_lattice(ny, nx, sy, sx):
    if ny < 0 or nx < 0 or sy < 1 or sx < 1:
        raise ValueError(f"bad lattice ny={ny} nx={nx} sy={sy} sx={sx}")


class _Counted:
    """Launch counts of one kernel wrapper: :attr:`launches` (one per
    launch, nothing else adds to it) and, in :attr:`launches_by_shape`, per
    output shape — for K2 followed by its strides ``(sy, sx)``. The
    ``ctypes`` entry points are looked up once, on the first launch."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_shape = collections.Counter()
        self._entries = {}

    def _entry(self, name: str):
        fn = self._entries.get(name)
        if fn is None:
            fn = self._entries[name] = getattr(load_library(), name)
        return fn

    def _launch(self, name, key, grids, gidx, ix, iy, keep, count,
                out_shape, *window):
        out = launch(self._entry(name), grids, gidx, ix, iy, keep, count,
                     out_shape, *window)
        self.launches += 1
        self.launches_by_shape[out_shape + key] += 1
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
        return self._launch("cg_score_volume", (), grids, gidx, ix, iy,
                            keep, count,
                            tuple(ix.shape[:2]) + (2 * ry + 1, 2 * rx + 1),
                            ry, rx)


class ScoreVolumeStridedKernel(_Counted):
    """K2's wrapper: the strided lattice ``(i - ny)·sy``, ``(j - nx)·sx``
    (``i < 2ny+1``, ``j < 2nx+1``), only its kept offsets computed.

    With ``known_cap`` it launches the fused pair instead: one pass that
    reads each cell ``v`` once and sums both ``v·k`` and ``k``, ``k = (v <
    known_cap)``, into ``[B, 2, T, Dy, Dx]`` (:func:`volume_pair_plain`'s
    result; the cap reaches the kernel as a C float, rounded to float32 as
    torch's comparison of a float32 grid with a Python float rounds it).
    It counts as a K2 launch."""

    def __call__(self, grids: torch.Tensor, gidx: torch.Tensor,
                 ix: torch.Tensor, iy: torch.Tensor, keep: torch.Tensor,
                 count: torch.Tensor, ny: int, nx: int, sy: int, sx: int,
                 known_cap: float | None = None) -> torch.Tensor:
        _check_inputs(grids, gidx, ix, iy, keep, count)
        _check_lattice(ny, nx, sy, sx)
        b, t = ix.shape[:2]
        dy, dx = 2 * ny + 1, 2 * nx + 1
        if known_cap is None:
            return self._launch("cg_score_volume_strided", (sy, sx), grids,
                                gidx, ix, iy, keep, count, (b, t, dy, dx),
                                ny, nx, sy, sx)
        return self._launch("cg_score_volume_pair", (sy, sx), grids, gidx,
                            ix, iy, keep, count, (b, 2, t, dy, dx), ny, nx,
                            sy, sx, known_cap)


class ScoreVolumeProbe(_Counted):
    """A timing probe of K1/K2's kernel body: WRONG RESULTS BY DESIGN.
    The body is the kernel's own (template parameter of the same source)
    with the grid read changed: ``"no_gather"`` computes each cell's value
    from its index and reads no memory (counterpart of the TPU probe
    ``_make_kernel_x1``); ``"const_cells"`` stages every point at one cell,
    so every load hits one L1 line (counterpart of ``_make_kernel_x2``).
    Launched only by ``chip_smoke.py`` and ``tools/bench_score_volume.py``,
    never by the main path; its counts are its own."""

    MODES = {"no_gather": 1, "const_cells": 2}

    def __init__(self, mode: str) -> None:
        super().__init__()
        self.mode = mode

    def _entry(self, name: str):
        return functools.partial(super()._entry(name), self.MODES[self.mode])

    def __call__(self, grids: torch.Tensor, gidx: torch.Tensor,
                 ix: torch.Tensor, iy: torch.Tensor, keep: torch.Tensor,
                 count: torch.Tensor, ny: int, nx: int, sy: int,
                 sx: int) -> torch.Tensor:
        _check_inputs(grids, gidx, ix, iy, keep, count)
        _check_lattice(ny, nx, sy, sx)
        return self._launch("cg_score_volume_probe", (sy, sx), grids, gidx,
                            ix, iy, keep, count,
                            tuple(ix.shape[:2]) + (2 * ny + 1, 2 * nx + 1),
                            ny, nx, sy, sx)


SCORE_VOLUME = ScoreVolumeKernel()
SCORE_VOLUME_STRIDED = ScoreVolumeStridedKernel()
PROBE_NO_GATHER = ScoreVolumeProbe("no_gather")
PROBE_CONST_CELLS = ScoreVolumeProbe("const_cells")
