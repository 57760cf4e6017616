"""The chain-tridiagonal preconditioner's cyclic-reduction solve as one
hand-written CUDA kernel (``csrc/cr_apply.cu``) over a compact factor.

``solver/cyclic_reduction.py:cr_factor`` factors the block-tridiagonal T
over super-blocks of ``3·group`` rows (48 at the solver's ``GROUP`` 16): each
level eliminates the odd super-blocks and keeps, per odd one, ``D⁻¹``, the
couplings ``Le``, ``Lo`` and the products ``A``, ``B``. Of those, only
``D⁻¹`` and the root inverse are dense: a coupling touches only the
(first pose of the next super-block) × (last pose of this one) corner, so
``Le`` and ``Lo`` are zero outside rows 0:3 × columns 45:48, ``A`` outside
rows 0:3 and ``B`` outside rows 45:48. :func:`pack_level` and
:func:`pack_root` keep just those entries, per graph contiguous
(:class:`Layout`): 667 KB a graph at 1024 poses where the dense levels held
2.9 MB.

The solve of T z = r for every column of ``r [B, C, N, 3]`` (the CG
state's layout; any strides) is :data:`CR_APPLY` on the card, and
:func:`cr_apply_plain` in plain PyTorch elsewhere (over the dense blocks
rebuilt from the compact factor once, so the CPU keeps its BLAS's bits). Both
zero the rows of frozen vertices (``free [B, N]``) on read and on write.
The source is built by
``ops/correlate.build`` (``nvcc``, ``sm_90a``, ``build/kernels/``) and
loaded on the first launch, so a process that never reaches a CG band
neither builds nor loads it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.ops.correlate import build

SRC = Path(__file__).resolve().parents[1] / "csrc" / "cr_apply.cu"
# the kernel's super-block: 16 poses of 3 rows
KERNEL_GROUP = 16
# column tiles the kernel is built for (one template instance each)
TILES = (2, 1)
# the kernel indexes a block's buffer and the grid in 32 bits
MAX_ITEMS = 1 << 30

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {torch.float32: "cg_cr_apply_f32", torch.float64: "cg_cr_apply_f64"}


@dataclasses.dataclass(frozen=True, eq=False)
class CrFactor:
    """A cyclic-reduction factorization in compact form: ``packed [B, F]``
    (a batch-1 factor has B = 1) laid out by :func:`layout`, over ``m``
    super-blocks (a power of two) of ``group`` poses; ``n3`` poses are
    live (the rest is padding). ``dataclasses.replace`` makes another
    factor (with a cache of its own)."""
    packed: torch.Tensor
    m: int
    n3: int
    group: int
    batched: bool

    @functools.cached_property
    def dense(self) -> tuple:
        """Every level's blocks as :func:`dense_level` rebuilds them, made
        on the first plain solve and kept with the factor, so that the
        plain version's solves (one a CG iteration) only multiply."""
        return tuple(dense_level(self, lvl) for lvl in range(levels(self.m)))


class Layout(NamedTuple):
    """Element offsets within one graph's packed factor. Level ``l`` has
    ``P = m >> (l + 1)`` pairs; its sections:

    * ``doi[l]``: ``D⁻¹`` of its odd super-blocks as ``[bb (column j)][P ·
      bb (pair t, row r)]``, so that the kernel's threads over (t, r) read
      consecutive addresses for each j;
    * ``ab[l]``: ``[bb (j)][P · 6]``, per pair rows 0:3 of ``A`` then rows
      bb−3:bb of ``B``;
    * ``corner[l]``: ``[P][2][3][3]``, ``Le`` and ``Lo`` at rows 0:3 ×
      columns bb−3:bb.

    ``root``: the root inverse as ``[bb (j)][bb (r)]``. All of ``doi`` and
    ``root`` first, then ``ab``, then ``corner``; ``size`` is rounded up to
    a multiple of 4 elements so that 16-byte loads stay aligned."""
    doi: tuple
    ab: tuple
    corner: tuple
    root: int
    size: int


def levels(m: int) -> int:
    return m.bit_length() - 1


def layout(m: int, group: int) -> Layout:
    bb = 3 * group
    pairs = [m >> (k + 1) for k in range(levels(m))]
    doi = tuple(bb * bb * (m - 2 * p) for p in pairs)
    ab = tuple(bb * bb * m + 6 * bb * (m - 2 * p) for p in pairs)
    corner = tuple(bb * bb * m + 6 * bb * (m - 1) + 18 * (m - 2 * p)
                   for p in pairs)
    size = bb * bb * m + (6 * bb + 18) * (m - 1)
    return Layout(doi=doi, ab=ab, corner=corner, root=bb * bb * (m - 1),
                  size=-(-size // 4) * 4)


def new_factor(b: int, m: int, n3: int, group: int, batched: bool,
               like: torch.Tensor) -> CrFactor:
    """An unfilled factor for ``b`` graphs (the tail padding zeroed)."""
    bb = 3 * group
    packed = torch.empty((b, layout(m, group).size), dtype=like.dtype,
                         device=like.device)
    packed[:, bb * bb * m + (6 * bb + 18) * (m - 1):] = 0.0
    return CrFactor(packed=packed, m=m, n3=n3, group=group, batched=batched)


def _section(fact: CrFactor, at: int, shape: tuple) -> torch.Tensor:
    return fact.packed[:, at:at + math.prod(shape)].view(
        (fact.packed.shape[0],) + shape)


def pack_level(fact: CrFactor, level: int, Doi, Le, Lo, A, B) -> None:
    """Keep what the solve reads of one level's ``[P, *lead, bb, bb]``
    blocks (``lead`` the batch's axis, or none)."""
    lay = layout(fact.m, fact.group)
    p = fact.m >> (level + 1)
    bb = 3 * fact.group
    b = fact.packed.shape[0]

    def blocks(x, rows=slice(None), cols=slice(None)):   # [P, B, rows, cols]
        y = x[..., rows, cols]
        return y.reshape((p, b) + y.shape[-2:])

    first, last = slice(0, 3), slice(bb - 3, bb)
    _section(fact, lay.doi[level], (bb, p, bb)).copy_(
        blocks(Doi).permute(1, 3, 0, 2))
    ab = _section(fact, lay.ab[level], (bb, p, 6))
    ab[..., 0:3].copy_(blocks(A, first).permute(1, 3, 0, 2))
    ab[..., 3:6].copy_(blocks(B, last).permute(1, 3, 0, 2))
    corner = _section(fact, lay.corner[level], (p, 2, 3, 3))
    corner[:, :, 0].copy_(blocks(Le, first, last).movedim(0, 1))
    corner[:, :, 1].copy_(blocks(Lo, first, last).movedim(0, 1))


def pack_root(fact: CrFactor, root_inv: torch.Tensor) -> None:
    """The root super-block's inverse (``[*lead, bb, bb]``)."""
    bb = 3 * fact.group
    _section(fact, layout(fact.m, fact.group).root, (bb, bb)).copy_(
        root_inv.reshape(-1, bb, bb).transpose(-1, -2))


def level_views(fact: CrFactor, level: int):
    """One level's kept entries as views of the packed factor, per graph
    and pair: ``D⁻¹ [B, P, bb, bb]``, ``A``'s rows 0:3 and ``B``'s rows
    bb−3:bb ``[B, P, 3, bb]``, the corners of ``Le`` and ``Lo`` ``[B, P,
    3, 3]``."""
    lay = layout(fact.m, fact.group)
    p = fact.m >> (level + 1)
    bb = 3 * fact.group
    doi = _section(fact, lay.doi[level], (bb, p, bb)).permute(0, 2, 3, 1)
    ab = _section(fact, lay.ab[level], (bb, p, 6)).permute(0, 2, 3, 1)
    corner = _section(fact, lay.corner[level], (p, 2, 3, 3))
    return doi, ab[:, :, 0:3], ab[:, :, 3:6], corner[:, :, 0], corner[:, :, 1]


def root_view(fact: CrFactor) -> torch.Tensor:
    """The root inverse ``[B, bb, bb]``."""
    bb = 3 * fact.group
    return _section(fact, layout(fact.m, fact.group).root,
                    (bb, bb)).transpose(-1, -2)


def _masked(x: torch.Tensor, free: torch.Tensor | None) -> torch.Tensor:
    if free is None:
        return x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(free[:, None, :, None], x, zero)


def dense_level(fact: CrFactor, level: int):
    """One level's blocks as the factorization computed them, rebuilt
    from the kept entries (the rest is exactly zero): ``D⁻¹``, ``Le``,
    ``Lo``, ``A``, ``B``, each ``[P, *lead, bb, bb]`` contiguous."""
    bb = 3 * fact.group
    doi, a3, b3, le, lo = level_views(fact, level)
    first, last = slice(0, 3), slice(bb - 3, bb)

    def lead(x):                        # [B, P, ...] → [P, *lead, ...]
        x = x.movedim(1, 0)
        return (x if fact.batched else x[:, 0]).contiguous()

    def place(x, rows, cols=slice(None)):
        full = x.new_zeros(x.shape[:2] + (bb, bb))
        full[..., rows, cols] = x
        return lead(full)

    return (lead(doi), place(le, first, last), place(lo, first, last),
            place(a3, first), place(b3, last))


def _sub_mm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``c − a @ b`` as one fused ``baddbmm`` over the leading axes."""
    if c.dim() == 3:
        return torch.baddbmm(c, a, b, alpha=-1.0)
    return torch.baddbmm(c.flatten(0, 1), a.flatten(0, 1), b.flatten(0, 1),
                         alpha=-1.0).unflatten(0, c.shape[:2])


def cr_apply_plain(fact: CrFactor, r: torch.Tensor,
                   free: torch.Tensor | None = None) -> torch.Tensor:
    """T z = r for ``r [B, C, N, 3]`` (``N = fact.n3``), ``free [B, N]``
    or None, in plain PyTorch: forward reduction over the levels (per
    even super-block, its rows less ``A`` times the previous odd one and
    ``B`` times the next), the root, then back (per odd super-block, its
    rows less ``Le`` times the previous even one and ``Loᵀ`` times the
    next, then times ``D⁻¹``), as batched products of each level's dense
    blocks (:attr:`CrFactor.dense`). Of those products only the kept entries'
    terms are not exact zeros; the kernel computes just those. The CPU
    keeps the dense products because its BLAS sums a 3-row or 3-deep
    product in another order than the 48-wide one, and the chain band's
    Newton–Schulz polish (``solver/spd.py``) turns on the last bits of
    what it is given. Returns a new ``[B, C, N, 3]`` tensor."""
    b, c, n, _ = r.shape
    m, group = fact.m, fact.group
    bb = 3 * group
    rhs = _masked(r, free).permute(2, 0, 3, 1)            # [N, B, 3, C]
    if not fact.batched:
        rhs = rhs[:, 0]
    lead = rhs.shape[1:-2]
    rhs = torch.cat([rhs, rhs.new_zeros((m * group - n,) + rhs.shape[1:])])
    # blocks of `group` poses: [m·group, *lead, 3, C] → [m, *lead, 3·group, C]
    rhs = rhs.reshape((m, group) + lead + (3, c)).movedim(1, -3).reshape(
        (m,) + lead + (bb, c))
    pad = torch.nn.functional.pad
    first = (0, 0) * (rhs.dim() - 1)          # no padding but on axis 0
    stack = []
    for lvl in range(levels(m)):
        doi, le, lo, a, bm = fact.dense[lvl]
        re, ro = rhs[0::2], rhs[1::2]
        ro_prev = pad(ro[:-1], first + (1, 0))               # r[2t−1]
        rhs = _sub_mm(_sub_mm(re, a, ro_prev), bm, ro)
        stack.append((doi, le, lo, ro))
    root = root_view(fact)
    x = (root if fact.batched else root[0]).contiguous()[None] @ rhs
    for (doi, le, lo, ro) in reversed(stack):
        # x holds this level's even solutions; recover the odds:
        # x[2t+1] = D⁻¹[2t+1] (r[2t+1] − L[2t] x[2t] − Lᵀ[2t+1] x[2t+2])
        x_next = pad(x[1:], first + (0, 1))
        xo = doi @ _sub_mm(_sub_mm(ro, le, x), lo.transpose(-1, -2), x_next)
        k2 = x.shape[0] + xo.shape[0]
        x = torch.stack([x, xo], dim=1).reshape((k2,) + x.shape[1:])
    x = x.reshape((m,) + lead + (group, 3, c)).movedim(-3, 1).reshape(
        (m * group,) + lead + (3, c))[:n]
    if not fact.batched:
        x = x[:, None]
    return _masked(x.permute(1, 3, 0, 2), free)


class Plan(NamedTuple):
    """A launch's shape: ``tile`` columns a block, ``threads`` a block,
    ``smem`` bytes of dynamic shared memory (0 when the block's buffer
    lies in ``scratch`` elements of device memory instead)."""
    tile: int
    threads: int
    smem: int
    scratch: int


# the kernel's buffer holds a super-block's 48 rows at a pitch of 49
PITCH = 49


def buffer_elems(m: int, tile: int) -> int:
    """A block's buffer: every super-block of its columns."""
    return m * PITCH * tile


def plan(b: int, c: int, m: int, itemsize: int, smem_limit: int,
         sms: int) -> Plan:
    """The kernel's tiling from what it can see: one block per (graph,
    tile of columns). Two columns share a block, and each read of the
    factor, where that still leaves the card two blocks per SM; a wider
    tile needs more registers and shared memory a block, fewer blocks
    fit an SM, and their waits on the factor show (measured on one H100
    at the star's 128 graphs × 384 columns: four columns a tile 1.4× and
    eight 1.7× slower than two). Threads come in multiples of 96 (whole
    warps and whole pairs): 96 where the grid is many times what the card
    holds at once, so that many small blocks share an SM and hide each other's
    waits; otherwise one per two four-row groups of level 0's odd
    super-blocks (3m, within 96–384), so that a block keeps more of its
    graph's factor in flight. A graph too long for one column's buffer in
    shared memory keeps it in device memory."""
    tile = 2 if c >= 2 and b * -(-c // 2) >= 2 * sms else 1
    blocks = b * -(-c // tile)
    threads = (96 if blocks >= 16 * sms
               else min(384, max(96, -(-3 * m // 96) * 96)))
    smem = buffer_elems(m, tile) * itemsize
    if smem <= smem_limit:
        return Plan(tile, threads, smem, 0)
    return Plan(tile, threads, 0, b * -(-c // tile) * buffer_elems(m, tile))


class CrApplyKernel:
    """The kernel's wrapper: checks its inputs, plans the launch,
    allocates the output (and, for a graph too long for shared memory,
    the blocks' buffers) and launches it on the current stream.
    :attr:`launches` counts calls (one launch each)."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._smem_limit = 0
        self._sms = {}

    def _entry(self, dtype: torch.dtype):
        if self._lib is None:
            lib = ctypes.CDLL(str(build(SRC)))
            for name in _ENTRIES.values():
                fn = getattr(lib, name)
                fn.argtypes = ([_PTR] * 5 + [_LONG] + [_INT] * 7
                               + [_LONG] * 8 + [_PTR])
                fn.restype = ctypes.c_int
            # the dynamic shared memory ceiling is raised once, here, and
            # never during a launch (which a captured graph replays)
            init = lib.cg_cr_apply_init
            init.argtypes = [ctypes.POINTER(ctypes.c_int)]
            init.restype = ctypes.c_int
            limit = ctypes.c_int(0)
            rc = init(ctypes.byref(limit))
            if rc != 0:
                raise RuntimeError(f"cyclic-reduction kernel set-up failed: "
                                   f"cudaError {rc}")
            self._smem_limit = limit.value
            self._lib = lib
        return getattr(self._lib, _ENTRIES[dtype])

    def _sm_count(self, device: torch.device) -> int:
        k = device.index if device.index is not None else \
            torch.cuda.current_device()
        if k not in self._sms:
            self._sms[k] = torch.cuda.get_device_properties(
                k).multi_processor_count
        return self._sms[k]

    def __call__(self, fact: CrFactor, r: torch.Tensor,
                 free: torch.Tensor | None = None) -> torch.Tensor:
        if r.device.type != "cuda":
            raise ValueError("the cyclic-reduction kernel takes CUDA tensors")
        b, c, n = check_inputs(fact, r, free)
        # column-first, as the CG state: a column-last z speeds the next
        # HVP (1.97 against 2.59 ms at 128 graphs × 384 columns on one
        # H100) but slows the kernel (4.10 against 3.52 ms) and the CG
        # state's updates that mix it with column-first vectors (a
        # 64-iteration marginal solve 1.27 against 1.08 s)
        z = torch.empty((b, c, n, 3), dtype=r.dtype, device=r.device)
        if z.numel() == 0:
            return z
        fn = self._entry(r.dtype)
        p = plan(b, c, fact.m, r.element_size(), self._smem_limit,
                 self._sm_count(r.device))
        scratch = (torch.empty(p.scratch, dtype=r.dtype, device=r.device)
                   if p.scratch else None)
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(fact.packed.data_ptr(), r.data_ptr(),
                None if free is None else free.data_ptr(), z.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                fact.packed.shape[1], b, c, n, fact.m, p.tile, p.threads,
                p.smem, *r.stride(), *z.stride(), stream)
        if rc != 0:
            raise RuntimeError(f"cyclic-reduction kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return z


def check_inputs(fact: CrFactor, r: torch.Tensor,
                 free: torch.Tensor | None) -> tuple:
    """Types, shapes, devices and layouts of a launch's inputs: ``r [B, C,
    N, 3]`` at any strides, ``free [B, N]`` bool contiguous or None, the
    factor's ``packed [B, F]`` contiguous, 16-byte aligned, of the
    kernel's group. Raises ``ValueError`` on what the kernel does not
    take. Returns ``(B, C, N)``."""
    if r.dim() != 4 or r.shape[-1] != 3:
        raise ValueError(f"r: want [B, C, N, 3], got {tuple(r.shape)}")
    b, c, n, _ = r.shape
    if r.dtype not in _ENTRIES:
        raise ValueError(f"r: want float32 or float64, got {r.dtype}")
    if fact.group != KERNEL_GROUP:
        raise ValueError(f"factor: the kernel takes group {KERNEL_GROUP}, "
                         f"got {fact.group}")
    pk = fact.packed
    size = layout(fact.m, fact.group).size
    if (pk.device != r.device or pk.dtype != r.dtype
            or tuple(pk.shape) != (b, size) or fact.n3 != n
            or n > fact.m * fact.group):
        raise ValueError(f"factor: want {r.dtype} ({b}, {size}) on "
                         f"{r.device} for {n} poses, got {pk.dtype} "
                         f"{tuple(pk.shape)} on {pk.device} for "
                         f"{fact.n3} poses")
    if not pk.is_contiguous() or pk.data_ptr() % 16:
        raise ValueError("factor: packed must be contiguous and 16-byte "
                         "aligned")
    if free is not None and (free.device != r.device
                             or free.dtype != torch.bool
                             or tuple(free.shape) != (b, n)
                             or not free.is_contiguous()):
        raise ValueError(f"free: want contiguous torch.bool ({b}, {n}) on "
                         f"{r.device}, got {free.dtype} {tuple(free.shape)} "
                         f"on {free.device}")
    if max(b * c, buffer_elems(fact.m, TILES[0])) >= MAX_ITEMS:
        raise ValueError(f"too large for 32-bit indices: B {b}, C {c}, "
                         f"m {fact.m}")
    return b, c, n


CR_APPLY = CrApplyKernel()
