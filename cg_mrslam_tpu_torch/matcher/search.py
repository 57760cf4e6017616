"""Correlative search over (x, y, θ) candidate transforms.

Port of ``cg_mrslam_tpu/matcher/search.py`` (the reference's
``greedySearch``, ``chargrid.cpp:208-308``): a whole score volume
``[T, Dy, Dx]`` per search — rotation applied once per θ, integer
translations reuse the rotated cells, consecutive duplicate cells dropped,
score = mean grid distance in meters (lower is better), out-of-grid points
add 0 but still normalize the mean.

Searches are batched: one call scores ``B`` (grid index, center, base)
triples, so the regions of a keyframe share one kernel launch, and every
level of a hierarchical search is one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cg_mrslam_tpu_torch.core.graph import first_k
from cg_mrslam_tpu_torch.matcher.grid import world_to_cell
from cg_mrslam_tpu_torch.ops.correlate import (
    SCORE_VOLUME,
    SCORE_VOLUME_STRIDED,
    volume_cells,
    volume_pair_plain,
    volume_plain,
)


class SearchResult(NamedTuple):
    poses: torch.Tensor   # [..., K, 3] candidate transforms, best first
    scores: torch.Tensor  # [..., K] mean-distance scores (lower = better)


def score_volume(grid: torch.Tensor, center: torch.Tensor,
                 resolution: float, points: torch.Tensor,
                 valid: torch.Tensor, base: torch.Tensor,
                 thetas: torch.Tensor, ty_cells: torch.Tensor,
                 tx_cells: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch score volume ``[T, Dy, Dx]`` for poses
    ``base ⊕ (tx·res, ty·res, θ)`` on one grid ``[C, C]``: the kernel's
    plain version (any integer lattice, any device)."""
    cells = grid.shape[0]
    ix, iy, keep, count = volume_cells(center[None], resolution, cells,
                                       points, valid[None], base[None],
                                       thetas)
    gidx = torch.zeros((1,), dtype=torch.int32, device=grid.device)
    return volume_plain(grid[None], gidx, ix, iy, keep, count, ty_cells,
                        tx_cells)[0]


def _half_width(lattice: torch.Tensor) -> int:
    """``r`` of a contiguous symmetric lattice ``[-r..r]`` (its length fixes
    the kernel's static window; the values are not read on the card)."""
    n = lattice.shape[0]
    if n % 2 != 1:
        raise ValueError(f"lattice of even length {n} is not [-r..r]")
    return (n - 1) // 2


def _stride(lattice) -> tuple:
    """``(n, s)`` of a symmetric lattice ``[-n..n]·s`` given on the host
    (numpy): its values fix the kernel's static lattice."""
    a = np.asarray(lattice)
    n = (len(a) - 1) // 2
    s = int(a[-1]) // n if n else 1
    if len(a) % 2 != 1 or s < 1 or not np.array_equal(
            a, np.arange(-n, n + 1) * s):
        raise ValueError(f"not a symmetric strided lattice: {a}")
    return n, s


def score_volume_auto(grids: torch.Tensor, gidx: torch.Tensor,
                      centers: torch.Tensor, resolution: float,
                      points: torch.Tensor, valid: torch.Tensor,
                      bases: torch.Tensor, thetas: torch.Tensor,
                      ty_cells, tx_cells, *,
                      kind: str = "contiguous",
                      known_cap: float | None = None) -> torch.Tensor:
    """Score volumes ``[B, T, Dy, Dx]`` for ``B`` searches — the reference's
    backend dispatch, batched: search ``b`` scores ``points`` (``[P,2]``
    shared or ``[B,P,2]``, mask ``valid [B,P]``) on ``grids[gidx[b]]``
    around ``centers[b]`` from ``bases[b]``. ``kind="contiguous"``: the
    lattices are ``[-r..r]`` tensors (K1); ``kind="strided"``: they are
    symmetric lattices ``[-n..n]·s`` given as numpy arrays (K2). A strided
    search with ``known_cap`` scores the pair of ``grid·known`` and
    ``known`` (``known = grid < known_cap``) in one pass: ``[B, 2, T, Dy,
    Dx]``.

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernel (or raise — there is no fallback)."""
    cells = grids.shape[-1]
    ix, iy, keep, count = volume_cells(centers, resolution, cells, points,
                                       valid, bases, thetas)
    cpu = grids.device.type == "cpu"
    if kind == "strided":
        (ny, sy), (nx, sx) = _stride(ty_cells), _stride(tx_cells)
        if cpu:
            lat = (torch.as_tensor(np.asarray(ty_cells)),
                   torch.as_tensor(np.asarray(tx_cells)))
            if known_cap is None:
                return volume_plain(grids, gidx, ix, iy, keep, count, *lat)
            return volume_pair_plain(grids, gidx, ix, iy, keep, count, *lat,
                                     known_cap)
        return SCORE_VOLUME_STRIDED(grids.contiguous(),
                                    gidx.to(torch.int32), ix, iy, keep,
                                    count, ny, nx, sy, sx, known_cap)
    if known_cap is not None:
        raise ValueError("known_cap needs the strided kind")
    if kind != "contiguous":
        raise ValueError(f"unknown score-volume kind {kind!r}")
    if cpu:
        return volume_plain(grids, gidx, ix, iy, keep, count, ty_cells,
                            tx_cells)
    return SCORE_VOLUME(grids.contiguous(), gidx.to(torch.int32), ix, iy,
                        keep, count, _half_width(ty_cells),
                        _half_width(tx_cells))


def volume_topk(scores: torch.Tensor, base: torch.Tensor,
                thetas: torch.Tensor, ty_cells: torch.Tensor,
                tx_cells: torch.Tensor, resolution: float, k: int,
                report: torch.Tensor | None = None) -> SearchResult:
    """Best-k poses of volumes ``[..., T, Dy, Dx]`` around ``base
    [..., 3]``. Equal scores keep the lower flat index first (the tie order
    of ``lax.top_k``; corridor volumes have exact ties). Selection runs on
    ``scores``; the returned score is read from ``report`` when given."""
    t, dy, dx = scores.shape[-3:]
    flat = scores.reshape(*scores.shape[:-3], -1)
    k = min(k, flat.shape[-1])
    vals, idx = first_k(-flat, k)
    it = idx // (dy * dx)
    iy = (idx // dx) % dy
    ix = idx % dx
    poses = torch.stack([
        base[..., 0, None] + tx_cells[ix] * resolution,
        base[..., 1, None] + ty_cells[iy] * resolution,
        base[..., 2, None] + thetas[it],
    ], dim=-1)
    if report is None:
        out = -vals
    else:
        out = torch.gather(report.reshape(flat.shape), -1, idx)
    return SearchResult(poses=poses, scores=out)


def make_lattice(span: float, step: float, device=None) -> torch.Tensor:
    """Symmetric lattice ``[-span..span]`` with ``step`` (static length)."""
    n = int(round(span / step))
    return torch.arange(-n, n + 1, dtype=torch.float32,
                        device=device) * step


# Prior weight on deviating from the search base (score units per
# meter/radian of offset). TIEBREAK only breaks exact ties of self-similar
# geometry; close matching passes a real motion-prior weight
# (``SearchWindows.close_prior_weight``). Acceptance thresholds always see
# the raw score.
TIEBREAK = 1e-4


def _offset_penalty(thetas_rel, ty_cells, tx_cells, resolution, weight):
    return weight * (
        torch.abs(thetas_rel)[:, None, None]
        + (torch.abs(ty_cells) * resolution)[None, :, None]
        + (torch.abs(tx_cells) * resolution)[None, None, :]
    )


def _lattices(resolution, th_span, th_res, x_span, y_span, device):
    thetas = make_lattice(th_span, th_res, device)
    ny = int(round(y_span / resolution))
    nx = int(round(x_span / resolution))
    ty = torch.arange(-ny, ny + 1, dtype=torch.int32, device=device)
    tx = torch.arange(-nx, nx + 1, dtype=torch.int32, device=device)
    return thetas, ty, tx


def grid_search_batched(grids: torch.Tensor, gidx: torch.Tensor,
                        centers: torch.Tensor, resolution: float,
                        points: torch.Tensor, valid: torch.Tensor,
                        bases: torch.Tensor, *, th_span: float,
                        th_res: float, x_span: float, y_span: float,
                        topk: int = 1, prior_weight: float = TIEBREAK
                        ) -> SearchResult:
    """``B`` one-shot region searches (reference ``greedySearch``): the full
    (θ × ty × tx) lattice at grid resolution around each base, in one
    score-volume call. Returns poses ``[B, K, 3]``, scores ``[B, K]``."""
    thetas, ty, tx = _lattices(resolution, th_span, th_res, x_span, y_span,
                               grids.device)
    raw = score_volume_auto(grids, gidx, centers, resolution, points,
                            valid, bases, thetas, ty, tx)
    scores = raw + _offset_penalty(thetas, ty, tx, resolution, prior_weight)
    return volume_topk(scores, bases, thetas, ty, tx, resolution, topk,
                       report=raw)


def grid_search(grid: torch.Tensor, center: torch.Tensor,
                resolution: float, points: torch.Tensor,
                valid: torch.Tensor, base: torch.Tensor, *, th_span: float,
                th_res: float, x_span: float, y_span: float, topk: int = 1,
                prior_weight: float = TIEBREAK) -> SearchResult:
    """One region search on one grid: poses ``[K, 3]``, scores ``[K]``."""
    gidx = torch.zeros((1,), dtype=torch.int32, device=grid.device)
    r = grid_search_batched(grid[None], gidx, center[None], resolution,
                            points, valid[None], base[None],
                            th_span=th_span, th_res=th_res, x_span=x_span,
                            y_span=y_span, topk=topk,
                            prior_weight=prior_weight)
    return SearchResult(poses=r.poses[0], scores=r.scores[0])


def min_pool(grid: torch.Tensor, w: int) -> torch.Tensor:
    """Separable ``w``-window min-pool of ``[C, C]`` with XLA's ``"SAME"``
    padding (``(w-1)//2`` cells before, the rest after, padded with +inf),
    rows first, then columns — the reference's ``reduce_window`` pair."""
    lo = (w - 1) // 2
    hi = w - 1 - lo
    pool = torch.nn.functional.max_pool2d
    neg = torch.nn.functional.pad(-grid[None, None], (0, 0, lo, hi),
                                  value=float("-inf"))
    neg = pool(neg, kernel_size=(w, 1), stride=1)
    neg = torch.nn.functional.pad(neg, (lo, hi, 0, 0), value=float("-inf"))
    return -pool(neg, kernel_size=(1, w), stride=1)[0, 0]


def hierarchical_search(grid: torch.Tensor, center: torch.Tensor,
                        resolution: float, points: torch.Tensor,
                        valid: torch.Tensor, base: torch.Tensor, *,
                        th_span: float, th_res: float, x_span: float,
                        y_span: float, levels: int = 4, branch: int = 16,
                        known_cap: float | None = None,
                        min_known: float = 0.0,
                        pool_coarse: bool = False) -> SearchResult:
    """Coarse-to-fine search (reference ``hierarchicalSearch``): level 0
    scans the full window at step ``2^(levels-1)`` and keeps ``branch``
    candidates; each finer level rescans a ±previous-step window around
    every survivor, all survivors in one batch. Returns poses ``[branch,
    3]`` and scores ``[branch]``, best first.

    ``known_cap`` scores on known cells only (grid < ``known_cap``) with a
    coverage floor ``min_known``: the masked and the coverage volume come
    from one pass over the grid (K2's fused pair on the card).
    ``pool_coarse`` scores every level coarser than step 1 on the grid
    min-pooled over that step (:func:`min_pool`). On the card every level
    is one launch of kernel K2."""
    dev = grid.device
    step0 = 2 ** (levels - 1)
    c2 = center.reshape(1, 2)

    def level_search(b, th_sp, th_st, x_sp, y_sp, cell_step, k, pool):
        s = b.shape[0]
        rel = make_lattice(th_sp, th_st, dev)
        ny = max(1, int(round(y_sp / (resolution * cell_step))))
        nx = max(1, int(round(x_sp / (resolution * cell_step))))
        ty_np = np.arange(-ny, ny + 1, dtype=np.int32) * cell_step
        tx_np = np.arange(-nx, nx + 1, dtype=np.int32) * cell_step
        ty = torch.as_tensor(ty_np, device=dev)
        tx = torch.as_tensor(tx_np, device=dev)
        g = min_pool(grid, cell_step) if (pool and cell_step > 1) else grid
        gidx = torch.zeros((s,), dtype=torch.int32, device=dev)
        vol = score_volume_auto(g[None], gidx, c2.expand(s, 2), resolution,
                                points, valid[None].expand(s, -1), b, rel,
                                ty_np, tx_np, kind="strided",
                                known_cap=known_cap)
        if known_cap is None:
            raw = vol
        else:
            s_m, s_i = vol[:, 0], vol[:, 1]
            # s_m = Σ_known dist / count, s_i = known_count / count: the
            # mean over known cells is s_m / s_i, the coverage s_i
            raw = s_m / torch.clamp(s_i, min=1e-6)
            raw = torch.where(s_i >= min_known, raw,
                              torch.full_like(raw, 1e3))
        scores = raw + _offset_penalty(rel, ty, tx, resolution, TIEBREAK)
        return volume_topk(scores, b, rel, ty, tx, resolution, k,
                           report=raw)

    res0 = level_search(base.reshape(1, 3), th_span, th_res * step0, x_span,
                        y_span, step0, branch, pool_coarse)
    poses, scores = res0.poses[0], res0.scores[0]

    step = step0
    for _ in range(1, levels):
        prev = step
        step //= 2
        refined = level_search(poses, th_res * prev, th_res * step,
                               resolution * prev, resolution * prev, step,
                               1, pool_coarse)
        poses = refined.poses[:, 0]
        scores = refined.scores[:, 0]

    order = torch.argsort(scores, stable=True)
    return SearchResult(poses=poses[order], scores=scores[order])


def unmatched_points(grid: torch.Tensor, center: torch.Tensor,
                     resolution: float, points: torch.Tensor,
                     valid: torch.Tensor, *,
                     dist_threshold: float = 0.3) -> torch.Tensor:
    """Mask of points NOT explained by the grid (reference
    ``searchNonMatchedPoints``): the grid distance at the point's cell
    exceeds ``dist_threshold``. Off-grid points are not counted. ``points``
    are in the grid's world frame."""
    cells = grid.shape[0]
    cell = world_to_cell(points, center, cells, resolution)
    inb = torch.all((cell >= 0) & (cell < cells), dim=-1)
    c = torch.clamp(cell, 0, cells - 1).long()
    v = grid[c[:, 1], c[:, 0]]
    return valid & inb & (v > dist_threshold)


def box_mean(grid: torch.Tensor, center: torch.Tensor, resolution: float,
             box_center: torch.Tensor, *,
             box_half: float = 0.3) -> torch.Tensor:
    """Mean grid value over the cells whose centres lie in a world-frame
    box (reference ``CharGrid::countPoints``). The cell centres are built
    in float32 in the reference's order, so the box edge (``|w − c| <=
    box_half``) takes the same cells; the masked sum runs over the whole
    grid, as the reference's does, and the count stays on the device."""
    cells = grid.shape[0]
    ax = (torch.arange(cells, dtype=torch.float32, device=grid.device)
          + 0.5 - cells / 2.0) * resolution
    mx = torch.abs(center[0] + ax - box_center[0]) <= box_half     # [C]
    my = torch.abs(center[1] + ax - box_center[1]) <= box_half
    m = my[:, None] & mx[None, :]                                  # row=y
    n = torch.clamp(torch.sum(m), min=1)
    return torch.sum(torch.where(m, grid, torch.zeros_like(grid))) / n
