"""Single-robot SLAM engine: one keyframe step over the fixed-capacity state.

Port of ``cg_mrslam_tpu/pipeline/slam.py`` (the reference's ``GraphSLAM`` +
``srslam`` main loop): per keyframe, ``addDataSM`` (new vertex + odometry
edge refined by close scan matching), ``findConstraints`` (pre-optimize,
candidate sets, covariance gate, per-region matching, windowed closure
vote) and ``optimize(5)``. :func:`keyframe_step` runs it as device work
with no host synchronization; :class:`BucketRunner` slices the state to a
power-of-two bucket that fits the live graph and fetches the packed
:class:`StepInfo` in one device-to-host copy per keyframe.

The reference's ``vmap`` over regions is an explicit batch dimension here:
the near searches of all regions are one score-volume call, and the loop
searches (each region's base and its π twin) another.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.core import graph as G
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.core.graph import PoseGraph, first_k, row
from cg_mrslam_tpu_torch.core.linearize import chi2
from cg_mrslam_tpu_torch.core.scan import ScanSet
from cg_mrslam_tpu_torch.matcher import matching
from cg_mrslam_tpu_torch.matcher.grid import build_grids
from cg_mrslam_tpu_torch.matcher.search import grid_search_batched
from cg_mrslam_tpu_torch.pipeline import closure as CL
from cg_mrslam_tpu_torch.pipeline import graph_dist as GD
from cg_mrslam_tpu_torch.solver import gauss_newton as gn
from cg_mrslam_tpu_torch.solver.chain import chain_order
from cg_mrslam_tpu_torch.utils import se2

# Per-region loop-closure hypotheses: top-TOPK_PER_DIR of the normal search
# and of the π-rotated twin, deduped jointly on the merge lattice.
TOPK_PER_DIR = 2
LC_HYPOTHESES = 2 * TOPK_PER_DIR


@dataclasses.dataclass(frozen=True)
class SlamState:
    """Single-robot SLAM state; vertex-ownership tensors support the
    multi-robot layer (foreign vertices interleave in the same slots)."""

    graph: PoseGraph
    scans: ScanSet
    buffer: CL.ClosureBuffer
    my_id: torch.Tensor     # [] int32
    v_owner: torch.Tensor   # [N] int32 — robot that created each slot
    v_remote: torch.Tensor  # [N] int32 — owner-local keyframe index


def init_state(cfg: Config, beams: int, initial_pose, ranges, fov: float,
               max_range: float, laser_offset=(0.0, 0.0, 0.0),
               my_id: int = 0, first_beam_angle: float | None = None,
               angular_step: float | None = None,
               device=None) -> SlamState:
    """``setInitialData``: gauge-fixed first vertex + its scan. ``device``
    defaults to the card (raises when there is none)."""
    dev = resolve_device(device)
    g = G.empty(cfg.max_vertices, cfg.max_edges, dev)
    g = G.add_vertex(g, torch.tensor(np.asarray(initial_pose, np.float32),
                                     device=dev), fixed=True)
    fba = -fov / 2 if first_beam_angle is None else first_beam_angle
    step = fov / beams if angular_step is None else angular_step
    scans = S.empty(cfg.max_vertices, beams, dev, first_beam_angle=fba,
                    angular_step=step, max_range=max_range)
    scans = dataclasses.replace(scans, laser_offset=torch.tensor(
        np.asarray(laser_offset, np.float32), device=dev))
    scans = S.set_scan(scans, 0, torch.tensor(
        np.asarray(ranges, np.float32), device=dev))
    buf = CL.empty(cfg.slam.window_loop_closure * cfg.max_regions
                   * LC_HYPOTHESES, dev)
    n = cfg.max_vertices
    v_remote = torch.full((n,), -1, dtype=torch.int32, device=dev)
    v_remote[0] = 0
    return SlamState(
        graph=g, scans=scans, buffer=buf,
        my_id=torch.tensor(my_id, dtype=torch.int32, device=dev),
        v_owner=torch.full((n,), my_id, dtype=torch.int32, device=dev),
        v_remote=v_remote)


def own_vertices(state: SlamState) -> torch.Tensor:
    """Mask of live vertices created by this robot."""
    return state.graph.vmask & (state.v_owner == state.my_id)


def newest_own(state: SlamState, k: int):
    """Slots of my newest ``k`` own keyframes, newest first (+valid)."""
    score = torch.where(own_vertices(state), state.v_remote,
                        torch.full_like(state.v_remote, -1))
    vals, slots = first_k(score, min(k, score.shape[-1]))
    return slots.to(torch.int32), vals >= 0


class StepInfo(NamedTuple):
    pose: torch.Tensor             # [3] optimized pose of the new vertex
    sm_accepted: torch.Tensor      # [] bool — close match used for odom
    closures_added: torch.Tensor   # [] — accepted loop closures this step
    chi2: torch.Tensor             # [] post-optimization chi2
    n_edges: torch.Tensor          # [] — live edges (host bucket mirror)
    regions_dropped: torch.Tensor  # [] — components beyond max_regions
    solver_backend: torch.Tensor   # [] — 0 dense, 1 chain, 2 PCG


def _const(values, device) -> torch.Tensor:
    """A small float32 constant on ``device``, copied without a host sync
    (an asynchronous copy from a fresh host tensor)."""
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


def _diag_info(d, device) -> torch.Tensor:
    return _const([d[0], 0.0, 0.0, d[1], 0.0, d[2]], device)


def _window_reference(state: SlamState, window: int):
    """World-frame points of my previous ≤``window`` own vertices' scans
    (the reference's close-matching vset)."""
    idxs, ok = newest_own(state, window)
    idxs = idxs.long()
    pts = S.scan_points(state.scans, idxs)                  # [W,B,2]
    world = se2.apply(state.graph.poses[idxs], pts)
    valid = (S.beam_valid(state.scans, idxs)
             & ok[:, None] & state.scans.smask[idxs][:, None])
    return world.reshape(-1, 2), valid.reshape(-1)


def _add_keyframe(state: SlamState, est, ranges, cfg: Config):
    """``addDataSM``: vertex from the dead-reckoned estimate; odometry edge
    refined by close scan matching."""
    g = state.graph
    dev = g.poses.device
    cur = g.n_vertices.long()
    prevs, _ = newest_own(state, 1)
    prev = prevs[0].long()
    prev_pose = row(g.poses, prev)

    ref_pts, ref_valid = _window_reference(state,
                                           cfg.slam.close_match_window)
    cur_pts, cur_valid = S.points_from_ranges(state.scans, ranges)
    # coverage crop: score only current points inside the previous scan's
    # coverage disk (frontier points reward sliding the match backwards)
    world_cur = se2.apply(est, cur_pts)
    in_cover = torch.linalg.norm(world_cur - prev_pose[:2], dim=-1) < (
        state.scans.max_range - 0.5)
    cur_valid = cur_valid & in_cover

    m = matching.close_match(ref_pts, ref_valid, cur_pts, cur_valid, est,
                             cfg=cfg.close_matcher, windows=cfg.windows)
    pose_new = torch.where(m.accepted, m.pose, est)
    z = se2.relative(prev_pose, pose_new)
    info = torch.where(m.accepted, _diag_info(cfg.slam.sm_info, dev),
                       _diag_info(cfg.slam.odom_info, dev))

    g = G.add_vertex(g, pose_new)
    g = G.add_edge(g, prev, cur, z, info, owner=state.my_id)
    scans = S.set_scan(state.scans, cur, ranges)
    at = cur.reshape(1)
    v_owner = state.v_owner.clone()
    v_owner[at] = state.my_id
    v_remote = state.v_remote.clone()
    v_remote[at] = row(state.v_remote, prev) + 1
    state = dataclasses.replace(state, graph=g, scans=scans,
                                v_owner=v_owner, v_remote=v_remote)
    return state, m.accepted


def _covariance_gate(g: PoseGraph, cur, reps, rvalid, cfg: Config,
                     order=None):
    """Mahalanobis gate on region representatives (reference
    ``checkCovariance``): marginal covariance with the gauge at the current
    vertex, χ²(2) cut, distances deflated by the perception range. The
    marginals go through the capacity-banded backend (``order`` = chain
    permutation)."""
    n = g.poses.shape[0]
    regauged = dataclasses.replace(
        g, fixed=torch.arange(n, device=g.poses.device) == cur)
    cov = gn.marginal_covariance_auto(
        regauged, reps, order=order, loop_cap=cfg.slam.loop_cap,
        chain_cg_iters=cfg.slam.gate_cg_iters,
        chain_cg_tol=cfg.slam.gate_cg_tol,
        pcg_cg_iters=cfg.slam.gate_pcg_iters,
        chol=True)  # the live path is batch-1: factorize, don't invert
    reps = reps.long()
    delta = g.poses[reps, :2] - row(g.poses, cur)[:2]       # [K,2]
    dist = torch.linalg.norm(delta, dim=-1)
    scale = torch.clamp(dist - cfg.slam.perception_range_deflate,
                        min=0.0) / (dist + 1e-9)
    dd = delta * scale[:, None]
    sol, _ = torch.linalg.solve_ex(cov[:, :2, :2], dd[..., None])
    d2 = torch.sum(dd * sol[..., 0], dim=-1)
    return rvalid & (d2 <= cfg.slam.chi2_gate)


class RegionMatch(NamedTuple):
    near_pose: torch.Tensor   # [K,3] close-window match around the estimate
    near_score: torch.Tensor  # [K]
    loop_pose: torch.Tensor   # [K,H,3] LC hypotheses
    loop_score: torch.Tensor  # [K,H]
    loop_keep: torch.Tensor   # [K,H] bool — survives the dedup lattice


def _merge_cells(poses: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    norm = torch.cat([poses[..., :2],
                      ((poses[..., 2:] + math.pi) % (2 * math.pi))
                      - math.pi], dim=-1)
    return torch.floor(norm / q + 0.5)


def _lattice_topk(poses: torch.Tensor, scores: torch.Tensor,
                  q: torch.Tensor, k: int):
    """Per-merge-cell non-max suppression + top-k over leading batch dims:
    from ``poses [..., R, 3]`` / ``scores [..., R]`` in best-first order,
    keep the best entry of each (dx, dy, dθ) lattice cell (the reference's
    pruned results map, ``chargrid.cpp:36-46``) and return the first ``k``
    distinct ones: ``(poses [..., k, 3], scores [..., k], valid [..., k])``.
    Non-kept entries are written to a trash slot ``k`` only."""
    r = poses.shape[-2]
    lead = poses.shape[:-2]
    dev = poses.device
    cells = _merge_cells(poses, q)                           # [...,R,3]
    same = torch.all(cells[..., :, None, :] == cells[..., None, :, :], -1)
    earlier = torch.tril(torch.ones((r, r), dtype=torch.bool, device=dev),
                         -1)
    dup = torch.any(same & earlier, dim=-1)
    rank = torch.cumsum((~dup).to(torch.int64), -1) - 1
    slot = torch.where(~dup & (rank < k), rank, torch.full_like(rank, k))
    nb = math.prod(lead)
    flat = (torch.arange(nb, device=dev).reshape(lead + (1,)) * (k + 1)
            + slot).reshape(-1)
    out_p = torch.zeros((nb * (k + 1), 3), dtype=poses.dtype, device=dev)
    out_p[flat] = poses.reshape(-1, 3)
    out_s = torch.full((nb * (k + 1),), float("inf"), dtype=scores.dtype,
                       device=dev)
    out_s[flat] = scores.reshape(-1)
    out_v = torch.zeros((nb * (k + 1),), dtype=torch.bool, device=dev)
    out_v[flat] = torch.ones((), dtype=torch.bool, device=dev)
    return (out_p.reshape(lead + (k + 1, 3))[..., :k, :],
            out_s.reshape(lead + (k + 1,))[..., :k],
            out_v.reshape(lead + (k + 1,))[..., :k])


def _match_regions(state: SlamState, est, cand, labels, regions,
                   cur_pts, cur_valid, cfg: Config) -> RegionMatch:
    """Per-component matching (reference ``findConstraints``). Each region
    rasterizes the scans of its ≤``cfg.region_vertices`` nearest members
    into an LC grid, then runs a near search (tight close window around the
    current estimate) and a loop search around the representative's pose
    plus its π-rotated twin; the normal and π hypotheses are deduped
    jointly on the (``lc_merge_dx``, ``lc_merge_dy``, ``lc_merge_dth``)
    lattice."""
    g = state.graph
    dev = g.poses.device
    mcfg = cfg.lc_matcher
    w = cfg.windows
    reps = regions.rep_vertex.long()
    rvalid = regions.valid
    nreg = reps.shape[0]

    in_comp = cand[None, :] & (labels[None, :] == labels[reps][:, None])
    d = torch.linalg.norm(g.poses[None, :, :2] - g.poses[reps, None, :2],
                          dim=-1)                             # [K,N]
    score = torch.where(in_comp, -d, torch.full_like(d, -1e9))
    _, mem = first_k(score, min(cfg.region_vertices, score.shape[-1]))
    mem_ok = torch.gather(in_comp, 1, mem) & state.scans.smask[mem]

    pts = S.scan_points(state.scans, mem)                    # [K,M,B,2]
    world = se2.apply(g.poses[mem], pts).reshape(nreg, -1, 2)
    pvalid = (S.beam_valid(state.scans, mem)
              & mem_ok[..., None]).reshape(nreg, -1)
    centers = g.poses[reps, :2]                              # [K,2]
    grids = build_grids(world, pvalid, centers, cells=mcfg.cells,
                        resolution=mcfg.resolution,
                        kernel_radius=mcfg.kernel_radius)    # [K,C,C]

    # coverage crop around each representative: a region grid only covers
    # what its member scans could see
    world_cur = se2.apply(est, cur_pts)
    in_cover = torch.linalg.norm(world_cur[None] - centers[:, None],
                                 dim=-1) < (state.scans.max_range - 2.0)
    cvalid = cur_valid[None, :] & in_cover                   # [K,P]

    far = float(mcfg.kernel_radius)
    gidx = torch.arange(nreg, dtype=torch.int32, device=dev)
    rn = grid_search_batched(
        grids, gidx, centers, mcfg.resolution, cur_pts, cvalid,
        est[None].expand(nreg, 3), th_span=w.close_dth, th_res=w.lc_th_res,
        x_span=w.close_dx, y_span=w.close_dy, topk=1,
        prior_weight=w.close_prior_weight)

    q = _const([w.lc_merge_dx, w.lc_merge_dy, w.lc_merge_dth], dev)
    base = g.poses[reps]                                     # [K,3]
    twin = torch.cat([base[:, :2], base[:, 2:] + math.pi], dim=-1)
    bases = torch.stack([base, twin], dim=1).reshape(-1, 3)  # [2K,3]
    # raw top-16 volume cells per direction, then per-merge-cell NMS → the
    # best TOPK_PER_DIR genuinely distinct candidate poses
    r = grid_search_batched(
        grids, torch.repeat_interleave(gidx, 2),
        torch.repeat_interleave(centers, 2, dim=0), mcfg.resolution,
        cur_pts, torch.repeat_interleave(cvalid, 2, dim=0), bases,
        th_span=w.lc_dth, th_res=w.lc_th_res, x_span=w.lc_dx,
        y_span=w.lc_dy, topk=16)
    poses2, scores2, valid2 = _lattice_topk(r.poses, r.scores, q,
                                            TOPK_PER_DIR)
    poses_h = poses2.reshape(nreg, -1, 3)                    # [K,H,3]
    scores_h = scores2.reshape(nreg, -1)                     # [K,H]
    valid_h = valid2.reshape(nreg, -1)
    # joint dedup across directions on the same lattice: when a normal
    # hypothesis and a twin land in one cell, keep the better (ties to the
    # lower index — normal before twin, rank order within a direction)
    cells = _merge_cells(poses_h, q)
    same = (torch.all(cells[:, :, None, :] == cells[:, None, :, :], -1)
            & valid_h[:, None, :] & valid_h[:, :, None])
    hidx = torch.arange(scores_h.shape[1], device=dev)
    beats = (scores_h[:, None, :] < scores_h[:, :, None]) | (
        (scores_h[:, None, :] == scores_h[:, :, None])
        & (hidx[None, :] < hidx[:, None])[None])
    keep = valid_h & ~torch.any(same & beats, dim=2)
    farv = torch.full_like(scores_h, far)
    scores_rep = torch.where(valid_h, scores_h, farv)
    return RegionMatch(
        near_pose=rn.poses[:, 0],
        near_score=torch.where(rvalid, rn.scores[:, 0],
                               torch.full_like(rn.scores[:, 0], far)),
        loop_pose=poses_h,
        loop_score=torch.where(rvalid[:, None], scores_rep, farv),
        loop_keep=keep & rvalid[:, None],
    )


def keyframe_step(state: SlamState, est: torch.Tensor, ranges: torch.Tensor,
                  cfg: Config):
    """One full keyframe: addDataSM → findConstraints → optimize(5) on the
    state's device. In the dense band (capacity ≤ ``DENSE_MAX_CHOL``) it
    makes no host synchronization; above it the chain band's runtime
    check reads one flag per solver call.

    Above ``DENSE_MAX`` every solver call gets the (owner, keyframe) slot
    permutation that makes merged multi-robot graphs block-tridiagonal;
    the batch-1 Cholesky band takes it and ignores it, as the reference
    does."""
    state, sm_ok = _add_keyframe(state, est, ranges, cfg)
    g = state.graph
    dev = g.poses.device
    cur = (g.n_vertices - 1).long()

    if g.poses.shape[-2] > gn.DENSE_MAX:
        order = chain_order(state.v_owner, state.v_remote, g.vmask)
    else:
        order = None
    solve_kw = dict(order=order, loop_cap=cfg.slam.loop_cap,
                    chain_cg_iters=cfg.slam.chain_cg_iters,
                    chain_cg_tol=cfg.slam.chain_cg_tol,
                    pcg_iters=cfg.slam.pcg_cg_iters,
                    chol=True)  # batch-1 live path

    # --- findConstraints (graph_slam.cpp:388-485) ---
    g = gn.optimize_auto(g, cfg.slam.pre_optimize_iterations, **solve_kw)

    dist = GD.bounded_distances(g, cur)
    sets = GD.candidate_sets(
        g, cur, dist, max_graph_dist_sm=cfg.slam.max_graph_dist_sm,
        min_graph_dist_lc=cfg.slam.min_graph_dist_lc,
        max_euc_dist_lc=cfg.slam.max_euc_dist_lc)
    # exclude my own vertices already used by close matching (the odometry
    # window) — their constraint is the refined odometry edge
    own = own_vertices(state)
    v_cur = row(state.v_remote, cur)
    recent = own & (state.v_remote
                    > v_cur - (cfg.slam.close_match_window + 1))
    cand = (sets.near | sets.loop) & ~recent
    # widen by ±neighbor_gap ids within each owner's keyframe sequence,
    # then require scans
    cand = GD.expand_neighbors(cand, state.v_owner, state.v_remote, g.vmask,
                               n_robots=cfg.mr.n_robots,
                               gap=cfg.slam.neighbor_gap)
    n = cand.shape[0]
    cand = (cand & state.scans.smask
            & (torch.arange(n, device=dev) != cur) & ~recent)
    labels = GD.components(g, cand)
    regions = GD.pick_regions(g, cand, labels, cur, cfg.max_regions)
    # components beyond capacity are dropped — count them (no silent caps)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    n_comp = torch.sum(cand & (labels == idx))
    regions_dropped = torch.clamp(n_comp - torch.sum(regions.valid), min=0)

    rvalid = _covariance_gate(g, cur, regions.rep_vertex, regions.valid,
                              cfg, order=order)

    cur_pts, cur_valid = S.points_from_ranges(state.scans, ranges)
    state = dataclasses.replace(state, graph=g)
    pose_cur = row(g.poses, cur)
    rm = _match_regions(state, pose_cur, cand, labels,
                        regions._replace(valid=rvalid), cur_pts, cur_valid,
                        cfg)

    k = cfg.max_regions
    reps = regions.rep_vertex
    info = _diag_info(cfg.slam.sm_info, dev).expand(k, 6)

    # direct edge vs windowed vote: own vertices within direct_id_gap
    # keyframes get an immediate close-match edge; everything else rides
    # the loop-closure vote
    id_gap = v_cur - state.v_remote[reps.long()]
    near_mode = own[reps.long()] & (id_gap <= cfg.slam.direct_id_gap)
    direct = (rvalid & near_mode
              & (rm.near_score < cfg.close_matcher.max_score))
    z_near = se2.relative(g.poses[reps.long()], rm.near_pose)
    g = G.add_edges_masked(g, reps, cur.to(reps.dtype).expand_as(reps),
                           z_near, info, direct, owner=state.my_id)

    # loop hypotheses (both per-region twins) ride the sliding window
    hypo = (rvalid[:, None] & ~near_mode[:, None] & rm.loop_keep
            & (rm.loop_score < cfg.lc_matcher.max_score))   # [K,H]
    reps_h = torch.repeat_interleave(reps, LC_HYPOTHESES)
    z_loop = se2.relative(g.poses[reps_h.long()],
                          rm.loop_pose.reshape(-1, 3))
    info_h = _diag_info(cfg.slam.sm_info, dev).expand(k * LC_HYPOTHESES, 6)
    buf = CL.insert(state.buffer, reps_h,
                    cur.to(reps_h.dtype).expand_as(reps_h), z_loop, info_h,
                    hypo.reshape(-1))
    buf2, accept, _ = CL.windowed_vote(
        buf, g.poses, window=cfg.slam.window_loop_closure,
        inlier_threshold=cfg.slam.inlier_threshold,
        min_inliers=cfg.slam.min_inliers)
    g = CL.add_accepted(g, buf, accept, owner=state.my_id)

    # --- optimize(5) (graph_slam.cpp:561-574) ---
    g = gn.optimize_auto(g, cfg.slam.gn_iterations, **solve_kw)

    state = dataclasses.replace(state, graph=g, buffer=buf2)
    info_out = StepInfo(
        pose=row(g.poses, cur), sm_accepted=sm_ok,
        closures_added=torch.sum(accept) + torch.sum(direct),
        chi2=chi2(g), n_edges=g.n_edges, regions_dropped=regions_dropped,
        solver_backend=gn.auto_backend(g, order=order,
                                       loop_cap=cfg.slam.loop_cap,
                                       chol=True))
    return state, info_out


# ---------------------------------------------------------------------------
# Active-size bucketing: the step runs on the smallest power-of-two slice of
# the state that fits the live graph plus one keyframe's worst-case growth
# (the dense solver is O(N³) in the slice it is given), and the result is
# spliced back. The buckets decide which solver band each keyframe runs, so
# they are the reference's, unchanged.
# ---------------------------------------------------------------------------

_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384)


def _bucket_for(need: int, cap: int) -> int:
    for b in _BUCKETS:
        if b >= need:
            return min(b, cap)
    return cap


def _slice_state(state: SlamState, nb: int, eb: int) -> SlamState:
    g = state.graph
    g = dataclasses.replace(
        g, poses=g.poses[:nb], vmask=g.vmask[:nb], fixed=g.fixed[:nb],
        e_ij=g.e_ij[:eb], e_z=g.e_z[:eb], e_info=g.e_info[:eb],
        emask=g.emask[:eb], e_level=g.e_level[:eb], e_owner=g.e_owner[:eb])
    scans = dataclasses.replace(state.scans, ranges=state.scans.ranges[:nb],
                                smask=state.scans.smask[:nb])
    return dataclasses.replace(state, graph=g, scans=scans,
                               v_owner=state.v_owner[:nb],
                               v_remote=state.v_remote[:nb])


def _splice(full: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    out = full.clone()
    out[:part.shape[0]] = part
    return out


def _merge_state(full: SlamState, part: SlamState) -> SlamState:
    fg, pg = full.graph, part.graph
    g = dataclasses.replace(
        fg,
        poses=_splice(fg.poses, pg.poses), vmask=_splice(fg.vmask, pg.vmask),
        fixed=_splice(fg.fixed, pg.fixed), e_ij=_splice(fg.e_ij, pg.e_ij),
        e_z=_splice(fg.e_z, pg.e_z), e_info=_splice(fg.e_info, pg.e_info),
        emask=_splice(fg.emask, pg.emask),
        e_level=_splice(fg.e_level, pg.e_level),
        e_owner=_splice(fg.e_owner, pg.e_owner),
        n_vertices=pg.n_vertices, n_edges=pg.n_edges)
    scans = dataclasses.replace(
        full.scans, ranges=_splice(full.scans.ranges, part.scans.ranges),
        smask=_splice(full.scans.smask, part.scans.smask))
    return dataclasses.replace(
        full, graph=g, scans=scans, buffer=part.buffer,
        v_owner=_splice(full.v_owner, part.v_owner),
        v_remote=_splice(full.v_remote, part.v_remote))


def _pack_info(i: StepInfo) -> torch.Tensor:
    """StepInfo as one float32 ``[9]`` (pose + 6 scalars) so the host
    fetches it in one transfer (n_edges is exact in float32 up to 2²⁴)."""
    tail = torch.stack([
        i.sm_accepted.to(torch.float32), i.closures_added.to(torch.float32),
        i.chi2.to(torch.float32), i.n_edges.to(torch.float32),
        i.regions_dropped.to(torch.float32),
        i.solver_backend.to(torch.float32)])
    return torch.cat([i.pose.to(torch.float32), tail])


def _unpack_info(v: np.ndarray) -> StepInfo:
    return StepInfo(pose=v[:3], sm_accepted=bool(v[3]),
                    closures_added=int(v[4]), chi2=float(v[5]),
                    n_edges=int(v[6]), regions_dropped=int(v[7]),
                    solver_backend=int(v[8]))


def _bucket_pair(state: SlamState, n_live: int, e_live: int):
    cap_n, cap_e = state.graph.capacity
    # worst-case growth: odometry edge + per-region direct edges (≤ the
    # buffer's per-keyframe insert quota) + a full closure-buffer flush
    buf_cap = state.buffer.mask.shape[0]
    grow_e = 1 + buf_cap + buf_cap // 2
    nb = _bucket_for(n_live + 1, cap_n)
    eb = _bucket_for(max(e_live + grow_e, 4 * nb), cap_e)
    return nb, eb


def keyframe_step_bucketed(state: SlamState, est, ranges, cfg: Config,
                           n_live: int, e_live: int):
    """:func:`keyframe_step` on the bucket slice that fits the live graph
    (``n_live``/``e_live`` are host ints); ``est``/``ranges`` may be host
    arrays. Returns ``(new_state, StepInfo of host scalars)`` after one
    device-to-host copy."""
    dev = state.graph.poses.device
    est = torch.from_numpy(np.array(est, np.float32)).to(dev,
                                                         non_blocking=True)
    ranges = torch.from_numpy(np.array(ranges, np.float32)).to(
        dev, non_blocking=True)
    cap_n, cap_e = state.graph.capacity
    nb, eb = _bucket_pair(state, n_live, e_live)
    if nb >= cap_n and eb >= cap_e:
        new_state, info = keyframe_step(state, est, ranges, cfg)
    else:
        part, info = keyframe_step(_slice_state(state, nb, eb), est, ranges,
                                   cfg)
        new_state = _merge_state(state, part)
    return new_state, _unpack_info(_pack_info(info).cpu().numpy())


def state_from_g2o(cfg: Config, path: str, my_id: int = 0,
                   device=None) -> SlamState:
    """Resume: a SlamState rebuilt from a saved ``.g2o`` checkpoint (the
    reference's ``loadGraph``, ``graph_slam.cpp:625-628``), on ``device``
    (the card by default). Vertex ownership comes back from the id
    namespacing ``id = runningId + robotId·baseId``."""
    from cg_mrslam_tpu_torch.io import g2o

    dev = resolve_device(device)
    loaded = g2o.load(path, max_vertices=cfg.max_vertices,
                      max_edges=cfg.max_edges, device=dev)
    if loaded.scans is None:
        raise ValueError(f"{path} carries no ROBOTLASER1 scans")
    ids = loaded.ids
    v_owner = np.where(ids >= 0, ids // cfg.slam.base_id, my_id)
    v_remote = np.where(ids >= 0, ids % cfg.slam.base_id, -1)
    g = loaded.graph
    if not loaded.has_edge_meta:
        # a .g2o without CGM_EDGE_META provenance lines: each edge is
        # attributed to its first endpoint's owner (a file this package
        # saved carries the exact owner and level instead)
        e_owner = v_owner[g.e_ij[:, 0].cpu().numpy()]
        g = dataclasses.replace(g, e_owner=torch.as_tensor(
            e_owner, dtype=torch.int32, device=dev))
    buf = CL.empty(cfg.slam.window_loop_closure * cfg.max_regions
                   * LC_HYPOTHESES, dev)
    return SlamState(
        graph=g, scans=loaded.scans, buffer=buf,
        my_id=torch.tensor(my_id, dtype=torch.int32, device=dev),
        v_owner=torch.as_tensor(v_owner, dtype=torch.int32, device=dev),
        v_remote=torch.as_tensor(v_remote, dtype=torch.int32, device=dev))


class BucketRunner:
    """Host-side bucketed stepping: tracks the live vertex/edge counts and
    dispatches :func:`keyframe_step_bucketed`. (The reference's compile
    prewarming has no counterpart: eager PyTorch compiles nothing.)"""

    def __init__(self, cfg: Config, n_live: int = 1, e_live: int = 0):
        self.cfg = cfg
        self.n_live, self.e_live = n_live, e_live

    def bucket(self, state: SlamState):
        """The (vertex, edge) bucket the next step runs in."""
        return _bucket_pair(state, self.n_live, self.e_live)

    def step(self, state: SlamState, est, ranges):
        state, info = keyframe_step_bucketed(state, est, ranges, self.cfg,
                                             self.n_live, self.e_live)
        self.n_live += 1
        self.e_live = info.n_edges
        return state, info


class SingleRobotSlam:
    """Host-side driver: dead reckoning + keyframe gate around the step
    (the reference's ``srslam.cpp`` main loop). Runs on the card unless
    ``device`` names another device."""

    def __init__(self, cfg: Config, beams: int, initial_pose, ranges,
                 fov: float, max_range: float,
                 laser_offset=(0.0, 0.0, 0.0),
                 first_beam_angle: float | None = None,
                 angular_step: float | None = None, device=None):
        from cg_mrslam_tpu_torch.utils.metrics import Recorder

        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, beams, initial_pose, ranges, fov,
                                max_range, laser_offset,
                                first_beam_angle=first_beam_angle,
                                angular_step=angular_step,
                                device=self.device)
        self._est = np.asarray(initial_pose, np.float64)
        self._kf_est = self._est.copy()
        self.infos: list = []
        self.metrics = Recorder()
        self.runner = BucketRunner(cfg)

    @classmethod
    def resume(cls, cfg: Config, path: str, my_id: int = 0,
               device=None) -> "SingleRobotSlam":
        """Continue a run from a ``.g2o`` checkpoint, on ``device`` (the
        card by default): dead reckoning restarts at the newest own
        keyframe."""
        from cg_mrslam_tpu_torch.utils.metrics import Recorder

        self = cls.__new__(cls)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = state_from_g2o(cfg, path, my_id, self.device)
        slots, _ = newest_own(self.state, 1)
        g = self.state.graph
        self._est = g.poses[slots[0]].cpu().numpy().astype(np.float64)
        self._kf_est = self._est.copy()
        self.infos = []
        self.metrics = Recorder()
        self.runner = BucketRunner(cfg, n_live=int(g.n_vertices),
                                   e_live=int(g.n_edges))
        return self

    def observe(self, rel_odom, ranges) -> bool:
        """Feed one odometry increment + scan; returns True when a keyframe
        was processed (gate: >0.25 m or >π/4 since the last)."""
        c, s = np.cos(self._est[2]), np.sin(self._est[2])
        self._est = np.array([
            self._est[0] + c * rel_odom[0] - s * rel_odom[1],
            self._est[1] + s * rel_odom[0] + c * rel_odom[1],
            (self._est[2] + rel_odom[2] + np.pi) % (2 * np.pi) - np.pi,
        ])
        dx = self._est[:2] - self._kf_est[:2]
        dth = (self._est[2] - self._kf_est[2] + np.pi) % (2 * np.pi) - np.pi
        if (np.hypot(*dx) <= self.cfg.slam.linear_update
                and abs(dth) <= self.cfg.slam.angular_update):
            return False
        bucket = self.runner.bucket(self.state)
        with self.metrics.timer("keyframe_latency", bucket=bucket[0]):
            self.state, info = self.runner.step(
                self.state, np.asarray(self._est, np.float32),
                np.asarray(ranges, np.float32))
        self.infos.append(info)
        self.metrics.log("chi2", info.chi2)
        self.metrics.log("closures_added", info.closures_added)
        self.metrics.log("sm_accepted", int(info.sm_accepted))
        if info.regions_dropped:
            self.metrics.log("regions_dropped", info.regions_dropped)
        # re-anchor dead reckoning on the optimized pose
        self._est = np.asarray(info.pose, np.float64)
        self._kf_est = self._est.copy()
        return True

    @property
    def poses(self) -> np.ndarray:
        n = int(self.state.graph.n_vertices)
        return self.state.graph.poses[:n].cpu().numpy()
