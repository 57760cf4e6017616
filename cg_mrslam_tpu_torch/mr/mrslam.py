"""Multi-robot SLAM: the inter-robot exchange protocol as tensor programs.

Port of ``cg_mrslam_tpu/mr/mrslam.py`` (the reference's ``MRGraphSLAM`` and
message layer, ``mr_graph_slam.cpp``, ``msg_factory.h``):

* **Combo** (``mr_graph_slam.cpp:564-605``): a robot's last ≤5 pose
  estimates + its newest scan. The receiver instantiates the unknown newest
  vertex (with its scan) and parks it for matching (``:118-252``).
* **Global matching** of the newest parked foreign vertex against the local
  map (``:254-329``): hierarchical search (kernel K2 on the card); success
  buffers an inter-robot closure hypothesis in a per-peer window voted like
  intra-robot closures (``:60-112``).
* **Closure list / condensed star** (``:607-670``): accepted closures are
  reported to the vertex owner, who condenses its own-edge graph onto those
  boundary vertices and ships the labeled star back; received stars are
  spliced wholesale.

Messages are fixed-shape tuples of tensors. ``jax`` ``mode="drop"``
scatters write to a trash row (``core/graph.py:put_drop``); ``lax.top_k``
is ``first_k``; the per-peer ``lax.scan`` is a loop over peers.

Not ported yet: the visibility gate (``detect_robot_in_range``, off by
default — :func:`try_match_parked` raises when it is set), the ``"optimal"``
gauge, the ``GraphMsg`` fallback, ``VertexArray``/``RobotLaser``/
``EdgeArray`` messages and ``mr_state_from_g2o``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.core import graph as G
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.core.graph import first_k, put_drop, row
from cg_mrslam_tpu_torch.matcher.grid import build_grid
from cg_mrslam_tpu_torch.matcher.search import hierarchical_search
from cg_mrslam_tpu_torch.mr import condensed as CG
from cg_mrslam_tpu_torch.pipeline import closure as CL
from cg_mrslam_tpu_torch.pipeline.slam import (SlamState, _const, init_state,
                                               newest_own)
from cg_mrslam_tpu_torch.solver.chain import chain_order
from cg_mrslam_tpu_torch.utils import se2

# static message capacities (wire shape, not behaviour); the closure-list
# and star capacities live in MRConfig
COMBO_POSES = 5        # reference ships last ≤5 poses (mr_graph_slam.cpp:572)
CLOSURE_LIST = 16      # default cap of cfg-less call sites
STAR_EDGES = 16


@dataclasses.dataclass(frozen=True)
class MRState:
    """One robot's full multi-robot SLAM state."""

    slam: SlamState
    parked: torch.Tensor          # [N] bool — foreign vertices awaiting a match
    park_age: torch.Tensor        # [N] int32 — keyframes since parked
    peer_buf: CL.ClosureBuffer    # [R, W] per-peer hypothesis windows
    in_closures: torch.Tensor     # [R, N] bool — MY vertices peer r closed on
    out_closures: torch.Tensor    # [R, N] bool — r-owned slots I closed on


class Combo(NamedTuple):
    """VertexArray + RobotLaser (reference ComboMessage), with the beam
    geometry of the sender's laser."""

    robot: torch.Tensor             # [] int32 — sender id
    poses: torch.Tensor             # [C, 3] newest first
    idxs: torch.Tensor              # [C] int32 — sender-local keyframe indices
    valid: torch.Tensor             # [C] bool
    ranges: torch.Tensor            # [B] — scan of the newest vertex
    first_beam_angle: torch.Tensor  # [] rad
    angular_step: torch.Tensor      # [] rad
    max_range: torch.Tensor         # [] m


class ClosureList(NamedTuple):
    idxs: torch.Tensor     # [L] int32 — RECEIVER-local vertex indices
    valid: torch.Tensor    # [L] bool
    dropped: torch.Tensor  # [] — closures beyond capacity (sender side)


class StarMsg(NamedTuple):
    gauge: torch.Tensor     # [] int32 — SENDER-local index
    boundary: torch.Tensor  # [K] int32 — SENDER-local indices
    z: torch.Tensor         # [K, 3]
    info: torch.Tensor      # [K, 6]
    valid: torch.Tensor     # [K] bool
    dropped: torch.Tensor   # [] — boundary beyond capacity (sender side)


def _leaves(obj) -> list:
    """The tensors of a flat dataclass, in field order (no copies)."""
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def _stack_buffers(bufs) -> CL.ClosureBuffer:
    return CL.ClosureBuffer(*(torch.stack(leaves) for leaves in zip(
        *(_leaves(b) for b in bufs))))


def _peer_buffer(st: MRState, peer) -> CL.ClosureBuffer:
    """Peer ``peer``'s window (``peer`` an int or a device scalar)."""
    pick = ((lambda a: a[peer]) if isinstance(peer, int)
            else (lambda a: row(a, peer)))
    return CL.ClosureBuffer(*(pick(a) for a in _leaves(st.peer_buf)))


def init_mr_state(cfg: Config, beams: int, initial_pose, ranges,
                  fov: float, max_range: float, my_id: int,
                  laser_offset=(0.0, 0.0, 0.0), device=None) -> MRState:
    """``init_state`` plus empty multi-robot bookkeeping; ``device``
    defaults to the card."""
    slam = init_state(cfg, beams, initial_pose, ranges, fov, max_range,
                      laser_offset, my_id=my_id, device=device)
    dev = slam.graph.poses.device
    n = cfg.max_vertices
    r = cfg.mr.n_robots
    w = cfg.mr.window_mr_loop_closure * 2
    peer_buf = _stack_buffers([CL.empty(w, dev) for _ in range(r)])
    return MRState(
        slam=slam,
        parked=torch.zeros((n,), dtype=torch.bool, device=dev),
        park_age=torch.zeros((n,), dtype=torch.int32, device=dev),
        peer_buf=peer_buf,
        in_closures=torch.zeros((r, n), dtype=torch.bool, device=dev),
        out_closures=torch.zeros((r, n), dtype=torch.bool, device=dev),
    )


def find_slots(state: SlamState, owner, ridx: torch.Tensor) -> torch.Tensor:
    """My slots holding vertices ``ridx [K]`` of robot ``owner`` (first
    match); N where absent."""
    n = state.v_owner.shape[0]
    owner = G._value(state.v_owner, owner)
    hit = (state.graph.vmask & (state.v_owner == owner))[None, :] & (
        state.v_remote[None, :] == ridx.reshape(-1, 1).to(torch.int32))
    first = torch.argmax(hit.to(torch.uint8), dim=-1)
    return torch.where(torch.any(hit, dim=-1), first,
                       torch.full_like(first, n)).to(torch.int32)


def find_slot(state: SlamState, owner, ridx) -> torch.Tensor:
    """My slot holding vertex ``ridx`` of robot ``owner``; N if absent."""
    ridx = G._value(state.v_remote, ridx)
    return find_slots(state, owner, ridx.reshape(1))[0]


def build_combo(st: MRState) -> Combo:
    """My last ≤5 own keyframes + newest scan (``constructComboMessage``)."""
    slots, ok = newest_own(st.slam, COMBO_POSES)
    scans = st.slam.scans
    s = slots.long()
    return Combo(
        robot=st.slam.my_id,
        poses=st.slam.graph.poses[s],
        idxs=st.slam.v_remote[s],
        valid=ok,
        ranges=row(scans.ranges, s[0]),
        first_beam_angle=scans.first_beam_angle,
        angular_step=scans.angular_step,
        max_range=scans.max_range,
    )


def _live(live, device) -> torch.Tensor:
    """A delivery flag (a Python bool or a bool tensor) as a device bool."""
    if isinstance(live, torch.Tensor):
        return live.to(device=device, dtype=torch.bool)
    return torch.full((), bool(live), dtype=torch.bool, device=device)


def receive_combo(st: MRState, combo: Combo, live) -> MRState:
    """Instantiate the sender's newest vertex if unknown and park it;
    refresh the estimates of the sender's known vertices that still carry
    no live edge (the reference's "Update estimate" branches,
    ``mr_graph_slam.cpp:131-155``)."""
    slam = st.slam
    n = slam.v_owner.shape[0]
    live = _live(live, slam.v_owner.device)
    slot = find_slot(slam, combo.robot, combo.idxs[:1])
    is_new = live & combo.valid[0] & (slot == n)
    g = slam.graph
    tgt = torch.where(is_new, g.n_vertices, n).reshape(1).long()  # n = drop

    g = dataclasses.replace(
        g,
        poses=put_drop(g.poses, tgt, combo.poses[0]),
        vmask=put_drop(g.vmask, tgt, True),
        n_vertices=torch.where(is_new, g.n_vertices + 1, g.n_vertices))
    scans = dataclasses.replace(
        slam.scans,
        ranges=put_drop(slam.scans.ranges, tgt, combo.ranges),
        smask=put_drop(slam.scans.smask, tgt, True))
    slam = dataclasses.replace(
        slam, graph=g, scans=scans,
        v_owner=put_drop(slam.v_owner, tgt, combo.robot),
        v_remote=put_drop(slam.v_remote, tgt, combo.idxs[0]))

    # every combo pose whose vertex I already hold and which carries no
    # live edge yet (parked / hypothesis-buffered) snaps to the estimate
    g = slam.graph
    em = g.emask.to(torch.int32)
    deg = torch.zeros((n,), dtype=torch.int32, device=em.device)
    deg.index_add_(0, g.e_ij[:, 0].long(), em)
    deg.index_add_(0, g.e_ij[:, 1].long(), em)
    slots = find_slots(slam, combo.robot, combo.idxs)
    known = live & combo.valid & (slots < n)
    upd = known & (deg[torch.clamp(slots, max=n - 1).long()] == 0)
    refreshed = torch.where(upd, slots, n).long()          # n = drop
    g = dataclasses.replace(g, poses=put_drop(g.poses, refreshed,
                                              combo.poses))
    slam = dataclasses.replace(slam, graph=g)
    return dataclasses.replace(
        st, slam=slam,
        parked=put_drop(st.parked, tgt, True),
        park_age=put_drop(st.park_age, tgt, 0))


def _local_map_grid(st: MRState, cfg: Config, window: int):
    """LC grid of my last ≤``window`` own scans, centered on my newest
    pose (the reference's 21-vertex window, ``mr_graph_slam.cpp:172-213``).
    Returns ``(grid, center, newest slot, map points, map valid)``."""
    slam = st.slam
    slots, ok = newest_own(slam, window)
    s = slots.long()
    pts = S.scan_points(slam.scans, s)
    world = se2.apply(slam.graph.poses[s], pts).reshape(-1, 2)
    valid = (S.beam_valid(slam.scans, s) & ok[:, None]
             & slam.scans.smask[s][:, None]).reshape(-1)
    center = row(slam.graph.poses, s[0])[:2]
    mcfg = cfg.lc_matcher
    grid = build_grid(world, valid, center, cells=mcfg.cells,
                      resolution=mcfg.resolution,
                      kernel_radius=mcfg.kernel_radius)
    return grid, center, s[0], world, valid


def try_match_parked(st: MRState, cfg: Config) -> MRState:
    """Global matching of the NEWEST parked foreign vertex against my local
    map (``findInterRobotConstraints``, ``mr_graph_slam.cpp:254-329``),
    one attempt per round; it runs whether or not anything is parked (the
    result is masked). Unmatched vertices age out after
    ``inter_robot_gap`` rounds. The search trusts the transmitted pose to
    ±(global_dx, global_dy) and ±global_th_span, scores on known map
    cells with a coverage floor, and min-pools its coarse levels."""
    if cfg.mr.detect_robot_in_range:
        raise NotImplementedError(
            "the visibility gate (detect_robot_in_range) is not ported yet")
    slam = st.slam
    n = slam.v_owner.shape[0]
    dev = slam.v_owner.device
    freshness = torch.where(st.parked, -st.park_age,
                            torch.full_like(st.park_age, -(1 << 30)))
    cand = torch.argmax(freshness)
    has = row(st.parked, cand)

    grid, center, my_ref, _, _ = _local_map_grid(
        st, cfg, 2 * cfg.mr.global_match_window + 1)
    cur_pts, cur_valid = S.points_from_ranges(
        slam.scans, row(slam.scans.ranges, cand))
    cur_valid = cur_valid & row(slam.scans.smask, cand)

    w = cfg.windows
    kr = cfg.lc_matcher.kernel_radius
    base = torch.cat([center, row(slam.graph.poses, cand)[2:]])
    res = hierarchical_search(
        grid, center, cfg.lc_matcher.resolution, cur_pts, cur_valid, base,
        th_span=w.global_th_span, th_res=w.global_th_res,
        x_span=w.global_dx, y_span=w.global_dy, levels=w.global_levels,
        branch=w.global_branch,
        known_cap=(kr * 0.999 if cfg.mr.global_min_known > 0 else None),
        min_known=cfg.mr.global_min_known, pool_coarse=True)
    pose, score = res.poses[0], res.scores[0]
    ok = has & (score < cfg.mr.max_score_mr)

    # matched: move the foreign vertex to the matched pose and buffer the
    # closure hypothesis my_ref -> cand (info diag(100,100,1000))
    g = slam.graph
    tgt = torch.where(ok, cand, n).reshape(1)
    g = dataclasses.replace(g, poses=put_drop(g.poses, tgt, pose))
    slam = dataclasses.replace(slam, graph=g)

    z = se2.relative(row(g.poses, my_ref), pose)
    ci = cfg.mr.closure_info
    info = _const([ci[0], 0.0, 0.0, ci[1], 0.0, ci[2]], dev)
    peer = row(slam.v_owner, cand)
    buf_r = CL.insert(_peer_buffer(st, peer), my_ref.reshape(1).to(
        torch.int32), cand.reshape(1).to(torch.int32), z[None], info[None],
        ok.reshape(1))
    at = peer.reshape(1).long()
    leaves = []
    for full, one in zip(_leaves(st.peer_buf), _leaves(buf_r)):
        full = full.clone()
        full[at] = one[None]
        leaves.append(full)

    # retry bookkeeping: matched or aged-out vertices leave the queue
    age2 = st.park_age + st.parked.to(torch.int32)
    drop = st.parked & ((age2 > cfg.mr.inter_robot_gap)
                        | ((torch.arange(n, device=dev) == cand) & ok))
    return dataclasses.replace(
        st, slam=slam, peer_buf=CL.ClosureBuffer(*leaves),
        parked=st.parked & ~drop, park_age=age2)


def vote_inter_robot(st: MRState, cfg: Config) -> MRState:
    """Per-peer windowed consistency vote (``checkInterRobotClosures``,
    ``mr_graph_slam.cpp:60-112``); accepted closures go into the graph and
    are recorded for the closure list to that peer."""
    slam = st.slam
    r = st.in_closures.shape[0]
    n = slam.v_owner.shape[0]
    out_c = st.out_closures
    bufs = []
    for peer in range(r):
        buf = _peer_buffer(st, peer)
        buf2, accept, _ = CL.windowed_vote(
            buf, slam.graph.poses, window=cfg.mr.window_mr_loop_closure,
            inlier_threshold=cfg.slam.inlier_threshold,
            min_inliers=cfg.mr.min_inliers_mr)
        g = CL.add_accepted(slam.graph, buf, accept, owner=slam.my_id)
        tgt = torch.where(accept, buf.v_new, n).long()
        out_c = out_c.clone()
        out_c[peer] = put_drop(out_c[peer], tgt, True)
        slam = dataclasses.replace(slam, graph=g)
        bufs.append(buf2)
    return dataclasses.replace(st, slam=slam, out_closures=out_c,
                               peer_buf=_stack_buffers(bufs))


def build_closure_list(st: MRState, peer: int, cap: int = CLOSURE_LIST,
                       off=0) -> ClosureList:
    """Remote indices of ``peer``'s vertices I accepted closures on (my
    condensed-graph request), newest first. ``off`` rotates the
    ``cap``-window through that ranking, so successive sends cover an
    overflowing set; the receiver unions the chunks."""
    v_remote = st.slam.v_remote
    sel = st.out_closures[peer] & (st.slam.v_owner == peer)
    n = sel.shape[0]
    cap = min(cap, n)
    score = torch.where(sel, v_remote, torch.full_like(v_remote, -1))
    n_sel = torch.sum(sel.to(torch.int32))
    order = torch.argsort(-score, stable=True)   # selected first, newest first
    rank = torch.empty((n,), dtype=torch.int32, device=sel.device)
    rank[order] = torch.arange(n, dtype=torch.int32, device=sel.device)
    rot = (rank + off) % torch.clamp(n_sel, min=1)
    keep = sel & (rot < cap)
    score2 = torch.where(keep, v_remote, torch.full_like(v_remote, -1))
    vals, slots = first_k(score2, cap)
    return ClosureList(idxs=v_remote[slots], valid=vals >= 0,
                       dropped=torch.clamp(n_sel - cap, min=0))


def receive_closure_list(st: MRState, peer: int, cl: ClosureList,
                         live) -> MRState:
    """Record which of MY vertices ``peer`` closed on — the boundary of the
    star I owe them. UNION semantics: idempotent under resend/reorder."""
    slots = find_slots(st.slam, st.slam.my_id, cl.idxs)
    n = st.slam.v_owner.shape[0]
    mask = put_drop(torch.zeros((n,), dtype=torch.bool,
                                device=slots.device),
                    torch.where(cl.valid, slots, n).long(), True)
    live = _live(live, slots.device)
    new_row = torch.where(live, mask | st.in_closures[peer],
                          st.in_closures[peer])
    in_c = st.in_closures.clone()
    in_c[peer] = new_row
    return dataclasses.replace(st, in_closures=in_c)


def build_star(st: MRState, peer: int, gauge_mode: str = "centroid",
               cap: int = STAR_EDGES) -> StarMsg:
    """Condense my own-edge graph onto the boundary ``peer`` requested
    (``computeCondensedGraph``, own edges only), under the (owner,
    keyframe) chain permutation. Only the ``"centroid"`` gauge is
    ported."""
    if gauge_mode != "centroid":
        raise NotImplementedError(f"gauge mode {gauge_mode!r} is not "
                                  "ported yet")
    slam = st.slam
    sel = st.in_closures[peer]
    cap = min(cap, sel.shape[0])
    score = torch.where(sel, slam.v_remote,
                        torch.full_like(slam.v_remote, -1))
    vals, slots = first_k(score, cap)
    slots = slots.to(torch.int32)
    valid = vals >= 0
    n_sel = torch.sum(sel.to(torch.int32))
    g = slam.graph
    own = G.own_edge_mask(g, slam.my_id)
    order = chain_order(slam.v_owner, slam.v_remote, g.vmask)
    gauge = CG.select_gauge_centroid(g, slots, valid)
    star = CG.condense(g, slots, valid, gauge, own, order)
    return StarMsg(
        gauge=row(slam.v_remote, gauge),
        boundary=slam.v_remote[slots.long()],
        z=star.z, info=star.info,
        valid=star.valid & torch.any(valid),
        dropped=torch.clamp(n_sel - cap, min=0))


def receive_star(st: MRState, peer: int, msg: StarMsg, live) -> MRState:
    """Splice ``peer``'s condensed star over its vertices in my graph
    (``insertEdgesFromRobot``); no delivery, no replacement."""
    slam = st.slam
    n = slam.v_owner.shape[0]
    gauge_slot = find_slot(slam, peer, msg.gauge)
    b_slots = find_slots(slam, peer, msg.boundary)
    ok = msg.valid & (b_slots < n) & (gauge_slot < n)
    star = CG.Star(gauge=torch.clamp(gauge_slot, max=n - 1),
                   boundary=torch.clamp(b_slots, max=n - 1),
                   z=msg.z, info=msg.info, valid=ok)
    spliced = CG.splice_star(slam.graph, star, owner=peer)
    live = _live(live, b_slots.device)
    g = G.PoseGraph(*(torch.where(live, a, b) for a, b in zip(
        _leaves(spliced), _leaves(slam.graph))))
    return dataclasses.replace(st, slam=dataclasses.replace(slam, graph=g))
