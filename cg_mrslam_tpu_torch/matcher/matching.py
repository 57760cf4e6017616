"""Matching policy layer (reference ``ScanMatcher``).

Port of ``cg_mrslam_tpu/matcher/matching.py``; this slice carries the close
(odometry-refinement) mode. Loop-closure regions are matched in
``pipeline/slam.py`` with the batched search; the hierarchical, global and
verification modes wait for the multi-robot slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.config import MatcherConfig, SearchWindows
from cg_mrslam_tpu_torch.matcher.grid import build_grid
from cg_mrslam_tpu_torch.matcher.search import grid_search


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
