"""Matching policy layer (reference ``ScanMatcher``).

Port of ``cg_mrslam_tpu/matcher/matching.py``: the four search modes —
close (odometry refinement), loop closure over regions and their π-rotated
twins, hierarchical loop closure, global (inter-robot, unknown relative
pose) — and the robot-in-range visibility gate ``verify_match``. Callers
pass world-frame reference points. On the card the region search is one
launch of kernel K1 on one shared grid, and each level of a hierarchical
search one launch of kernel K2's single-grid entry. (The keyframe step
matches its regions in ``pipeline/slam.py`` with the batched search, and
parked foreign vertices are matched in ``mr/mrslam.py:try_match_parked``.)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.config import MatcherConfig, SearchWindows
from cg_mrslam_tpu_torch.matcher.grid import build_grid, subsample
from cg_mrslam_tpu_torch.matcher.search import (SearchResult, box_mean,
                                                grid_search,
                                                grid_search_batched,
                                                hierarchical_search,
                                                unmatched_points)


class Match(NamedTuple):
    pose: torch.Tensor      # [3] matched transform (world pose of the scan)
    score: torch.Tensor     # [] mean-distance score
    accepted: torch.Tensor  # [] bool — score < max_score


def _grid(cfg: MatcherConfig, ref_points, ref_valid, center):
    return build_grid(ref_points, ref_valid, center, cells=cfg.cells,
                      resolution=cfg.resolution,
                      kernel_radius=cfg.kernel_radius)


def close_match(ref_points: torch.Tensor, ref_valid: torch.Tensor,
                cur_points: torch.Tensor, cur_valid: torch.Tensor,
                guess: torch.Tensor, *, cfg: MatcherConfig,
                windows: SearchWindows) -> Match:
    """Sequential odometry refinement (``closeScanMatching``): search a
    ±0.3 m / ±0.2 rad window around the odometry guess."""
    center = guess[:2]
    grid = _grid(cfg, ref_points, ref_valid, center)
    res = grid_search(
        grid, center, cfg.resolution, cur_points, cur_valid, guess,
        th_span=windows.close_dth, th_res=windows.close_th_res,
        x_span=windows.close_dx, y_span=windows.close_dy, topk=1,
        prior_weight=windows.close_prior_weight)
    return Match(pose=res.poses[0], score=res.scores[0],
                 accepted=res.scores[0] < cfg.max_score)


def loop_closure_match(ref_points: torch.Tensor, ref_valid: torch.Tensor,
                       cur_points: torch.Tensor, cur_valid: torch.Tensor,
                       region_poses: torch.Tensor,
                       region_valid: torch.Tensor, *, cfg: MatcherConfig,
                       windows: SearchWindows) -> SearchResult:
    """Loop-closure search (``scanMatchingLC``): one region per candidate
    pose ``[R, 3]`` plus a π-rotated twin each, on one grid centred on the
    mean of the valid regions. Returns per-region best poses ``[2R, 3]``
    and scores ``[2R]``; invalid regions score ``kernel_radius``. The 2R
    searches are one batched call (one K1 launch on the card)."""
    xy = region_poses[:, :2]
    center = (torch.sum(torch.where(region_valid[:, None], xy,
                                    torch.zeros_like(xy)), dim=0)
              / torch.clamp(torch.sum(region_valid), min=1))
    grid = _grid(cfg, ref_points, ref_valid, center)

    twins = region_poses.clone()
    twins[:, 2] = twins[:, 2] + math.pi
    bases = torch.cat([region_poses, twins], dim=0)              # [2R,3]
    bvalid = torch.cat([region_valid, region_valid], dim=0)
    b = bases.shape[0]
    gidx = torch.zeros((b,), dtype=torch.int32, device=grid.device)
    res = grid_search_batched(
        grid[None], gidx, center.expand(b, 2), cfg.resolution, cur_points,
        cur_valid[None].expand(b, -1), bases, th_span=windows.lc_dth,
        th_res=windows.lc_th_res, x_span=windows.lc_dx,
        y_span=windows.lc_dy, topk=1)
    scores = torch.where(bvalid, res.scores[:, 0],
                         torch.full_like(res.scores[:, 0],
                                         cfg.kernel_radius))
    return SearchResult(poses=res.poses[:, 0], scores=scores)


def loop_closure_match_hierarchical(
        ref_points: torch.Tensor, ref_valid: torch.Tensor,
        cur_points: torch.Tensor, cur_valid: torch.Tensor,
        guess: torch.Tensor, *, cfg: MatcherConfig,
        windows: SearchWindows) -> Match:
    """Alternative loop-closure mode (``scanMatchingLChierarchical``): one
    coarse-to-fine search over ±2 m × ±1 rad around the guess, θ step
    ``lc_th_res``, 3 levels, on the scan's points thinned to one per 0.1 m
    cell (:func:`~cg_mrslam_tpu_torch.matcher.grid.subsample`)."""
    center = guess[:2]
    grid = _grid(cfg, ref_points, ref_valid, center)
    cur_valid = cur_valid & subsample(cur_points, cur_valid, center,
                                      cells=cfg.cells, resolution=0.1)
    res = hierarchical_search(
        grid, center, cfg.resolution, cur_points, cur_valid, guess,
        th_span=1.0, th_res=windows.lc_th_res, x_span=2.0, y_span=2.0,
        levels=3)
    return Match(pose=res.poses[0], score=res.scores[0],
                 accepted=res.scores[0] < cfg.max_score)


def global_match(ref_points: torch.Tensor, ref_valid: torch.Tensor,
                 cur_points: torch.Tensor, cur_valid: torch.Tensor,
                 guess: torch.Tensor, *, cfg: MatcherConfig,
                 windows: SearchWindows) -> Match:
    """Inter-robot matching with unknown relative pose
    (``globalMatching``): a ``global_levels``-level hierarchical search
    over ±``global_dx`` × ±``global_dy`` × full −π..π around the guess."""
    center = guess[:2]
    grid = _grid(cfg, ref_points, ref_valid, center)
    res = hierarchical_search(
        grid, center, cfg.resolution, cur_points, cur_valid, guess,
        th_span=math.pi, th_res=windows.global_th_res,
        x_span=windows.global_dx, y_span=windows.global_dy,
        levels=windows.global_levels)
    return Match(pose=res.poses[0], score=res.scores[0],
                 accepted=res.scores[0] < cfg.max_score)


def verify_match(map_points: torch.Tensor, map_valid: torch.Tensor,
                 my_points: torch.Tensor, my_valid: torch.Tensor,
                 other_position: torch.Tensor, *, cfg: MatcherConfig,
                 threshold: float = 40.0) -> torch.Tensor:
    """Robot-in-range visibility gate (``verifyMatching``): is the peer's
    BODY visible in my scan at its claimed position? My points that the
    peer's map does not explain (grid distance above 0.3 m, clamped below
    the grid's saturation ``kernel_radius``) are rasterized into a second
    grid, whose mean over a ±0.3 m box around the claimed position is low
    exactly when they cluster there. Detected ⇔ mean ≤ ``threshold`` / 128
    (the reference's uint8 grid scale). Both point sets are in MY world
    frame. Launches no kernel, and reads nothing on the host."""
    grid = _grid(cfg, map_points, map_valid, other_position)
    thr = min(0.3, cfg.kernel_radius * 0.99)
    um = unmatched_points(grid, other_position, cfg.resolution, my_points,
                          my_valid, dist_threshold=thr)
    aux = _grid(cfg, my_points, um, other_position)
    score = box_mean(aux, other_position, cfg.resolution, other_position,
                     box_half=0.3)
    return score <= threshold / 128.0
