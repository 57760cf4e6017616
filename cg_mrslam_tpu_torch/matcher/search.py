"""Correlative search over (x, y, θ) candidate transforms.

Port of ``cg_mrslam_tpu/matcher/search.py`` (the reference's
``greedySearch``, ``chargrid.cpp:208-308``): a whole score volume
``[T, Dy, Dx]`` per search — rotation applied once per θ, integer
translations reuse the rotated cells, consecutive duplicate cells dropped,
score = mean grid distance in meters (lower is better), out-of-grid points
add 0 but still normalize the mean.

Searches are batched: one call scores ``B`` (grid index, center, base)
triples, so the regions of a keyframe share one kernel launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import first_k
from cg_mrslam_tpu_torch.ops.correlate import (
    SCORE_VOLUME,
    volume_cells,
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


def score_volume_auto(grids: torch.Tensor, gidx: torch.Tensor,
                      centers: torch.Tensor, resolution: float,
                      points: torch.Tensor, valid: torch.Tensor,
                      bases: torch.Tensor, thetas: torch.Tensor,
                      ty_cells: torch.Tensor, tx_cells: torch.Tensor
                      ) -> torch.Tensor:
    """Score volumes ``[B, T, Dy, Dx]`` for ``B`` searches — the reference's
    backend dispatch for its ``"contiguous"`` kind (the strided kind waits
    for the multi-robot slice), batched: search ``b`` scores ``points``
    (``[P,2]`` shared or ``[B,P,2]``, mask ``valid [B,P]``) on
    ``grids[gidx[b]]`` around ``centers[b]`` from ``bases[b]``.
    ``ty_cells``/``tx_cells`` are contiguous ``[-r..r]`` lattices.

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernel (or raise — there is no fallback)."""
    cells = grids.shape[-1]
    ix, iy, keep, count = volume_cells(centers, resolution, cells, points,
                                       valid, bases, thetas)
    if grids.device.type == "cpu":
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
