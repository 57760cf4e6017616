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

Also: the full-graph ``GraphMsg`` fallback (:func:`build_graph_msg`,
:func:`receive_graph_msg`), the standalone ``VertexArray``/``RobotLaser``/
``EdgeArray`` messages of the wire codec (``mr/wire.py``) and the
multi-robot resume :func:`mr_state_from_g2o`.

Two options of the reference, off by default as there: the visibility
gate of :func:`try_match_parked` (``MRConfig.detect_robot_in_range``) and
the uncertainty-minimizing gauge of :func:`build_star`
(``gauge_mode="optimal"``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.core import graph as G
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.core.graph import first_k, put_drop, row
from cg_mrslam_tpu_torch.matcher import matching
from cg_mrslam_tpu_torch.matcher.grid import build_grid
from cg_mrslam_tpu_torch.matcher.search import hierarchical_search
from cg_mrslam_tpu_torch.mr import condensed as CG
from cg_mrslam_tpu_torch.pipeline import closure as CL
from cg_mrslam_tpu_torch.pipeline.slam import (SlamState, _const, init_state,
                                               newest_own, state_from_g2o)
from cg_mrslam_tpu_torch.solver.chain import chain_order
from cg_mrslam_tpu_torch.utils import se2

# static message capacities (wire shape, not behaviour); the closure-list
# and star capacities live in MRConfig
COMBO_POSES = 5        # reference ships last ≤5 poses (mr_graph_slam.cpp:572)
CLOSURE_LIST = 16      # default cap of cfg-less call sites
STAR_EDGES = 16
GRAPH_MSG_V = 128      # GraphMsg fallback capacities
GRAPH_MSG_E = 256


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


class VertexArray(NamedTuple):
    """Standalone vertex-estimate message (reference VertexArrayMessage,
    type 1, ``msg_factory.h:141-160``)."""

    robot: torch.Tensor   # [] int32
    poses: torch.Tensor   # [C, 3]
    idxs: torch.Tensor    # [C] int32 — sender-local indices
    valid: torch.Tensor   # [C] bool


class RobotLaser(NamedTuple):
    """Standalone laser message (reference RobotLaserMessage, type 2,
    ``msg_factory.h:162-181``: node id, readings and the laser's
    parameters)."""

    robot: torch.Tensor             # [] int32
    node_id: torch.Tensor           # [] int32 — sender-local vertex index
    ranges: torch.Tensor            # [B]
    first_beam_angle: torch.Tensor  # [] rad (minangle)
    angular_step: torch.Tensor      # [] rad (angleincrement)
    max_range: torch.Tensor         # [] m
    accuracy: torch.Tensor          # [] m


class EdgeArray(NamedTuple):
    """Standalone edge message (reference EdgeArrayMessage, type 5,
    ``msg_factory.h:200-221``: id pairs, estimates and 6 information
    floats)."""

    robot: torch.Tensor   # [] int32
    ids: torch.Tensor     # [E, 2] int32 — sender-local index pairs
    z: torch.Tensor       # [E, 3]
    info: torch.Tensor    # [E, 6]
    valid: torch.Tensor   # [E] bool


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


class GraphMsg(NamedTuple):
    """Full-graph fallback: the sender's newest own vertices and the own
    edges among them (reference ``constructGraphMessage`` /
    ``addInterRobotDataGraph``, ``mr_graph_slam.cpp:397-483``, ``:672-739``
    — present in the reference but not in its send loop)."""

    robot: torch.Tensor    # [] int32
    poses: torch.Tensor    # [V, 3]
    idxs: torch.Tensor     # [V] int32 — sender-local indices
    vvalid: torch.Tensor   # [V] bool
    e_ij: torch.Tensor     # [E, 2] int32 — sender-local index pairs
    e_z: torch.Tensor      # [E, 3]
    e_info: torch.Tensor   # [E, 6]
    evalid: torch.Tensor   # [E] bool


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


def mr_state_from_g2o(cfg: Config, path: str, my_id: int,
                      device=None) -> MRState:
    """Multi-robot resume from a ``.g2o`` checkpoint of this package (or
    the reference's), on ``device`` (the card by default). Edge provenance
    (owner, level) comes back from the ``CGM_EDGE_META`` lines, so
    ``build_star``'s own-edges rule holds after a resume: received star
    edges are not condensed again (``condensed_graph_buffer.cpp:347-366``).

    ``out_closures`` (the peer vertices I accepted closures on) is
    recovered from the graph: my own level-0 edges whose far end is
    peer-owned. ``in_closures`` (what peers accepted on my vertices) cannot
    be; peers resend their closure lists every round, so it refills on the
    first exchange."""
    slam = state_from_g2o(cfg, path, my_id, device)
    dev = slam.graph.poses.device
    n = cfg.max_vertices
    r = cfg.mr.n_robots
    w = cfg.mr.window_mr_loop_closure * 2
    g = slam.graph
    mine = G.own_edge_mask(g, my_id) & (g.e_level == 0)
    vo = slam.v_owner
    out_c = torch.zeros((r + 1, n), dtype=torch.bool, device=dev)  # r: trash
    for endpoint in (0, 1):
        tgt = g.e_ij[:, endpoint].long()
        foreign = mine & (vo[tgt] != my_id) & g.vmask[tgt] & (vo[tgt] < r)
        out_c[torch.where(foreign, vo[tgt], r).long(), tgt] = True
    return MRState(
        slam=slam,
        parked=torch.zeros((n,), dtype=torch.bool, device=dev),
        park_age=torch.zeros((n,), dtype=torch.int32, device=dev),
        peer_buf=_stack_buffers([CL.empty(w, dev) for _ in range(r)]),
        in_closures=torch.zeros((r, n), dtype=torch.bool, device=dev),
        out_closures=out_c[:r].clone(),
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
    cells with a coverage floor, and min-pools its coarse levels. With
    ``detect_robot_in_range`` a match also has to pass the visibility gate
    (:func:`matching.verify_match`), on the device, with no host read."""
    slam = st.slam
    n = slam.v_owner.shape[0]
    dev = slam.v_owner.device
    freshness = torch.where(st.parked, -st.park_age,
                            torch.full_like(st.park_age, -(1 << 30)))
    cand = torch.argmax(freshness)
    has = row(st.parked, cand)

    grid, center, my_ref, map_world, map_valid = _local_map_grid(
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

    if cfg.mr.detect_robot_in_range:
        # visibility gate (mr_graph_slam.cpp:218-226 / :291-299): accept the
        # match only if my scan sees the peer's body — points unexplained
        # by its scan — at the claimed position (its scan is the "map")
        peer_world = se2.apply(pose, cur_pts)
        detected = matching.verify_match(
            peer_world, cur_valid, map_world, map_valid, pose[:2],
            cfg=cfg.lc_matcher, threshold=cfg.windows.verify_threshold)
        ok = ok & detected

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


def star_inputs(st: MRState, peer: int, cap: int = STAR_EDGES):
    """What :func:`build_star` condenses: ``(graph, boundary slots [cap],
    valid [cap], own-edge mask, chain order, requested count)`` — the
    newest ≤ ``cap`` vertices ``peer`` closed on."""
    slam = st.slam
    sel = st.in_closures[peer]
    cap = min(cap, sel.shape[0])
    score = torch.where(sel, slam.v_remote,
                        torch.full_like(slam.v_remote, -1))
    vals, slots = first_k(score, cap)
    g = slam.graph
    return (g, slots.to(torch.int32), vals >= 0,
            G.own_edge_mask(g, slam.my_id),
            chain_order(slam.v_owner, slam.v_remote, g.vmask),
            torch.sum(sel.to(torch.int32)))


def build_star(st: MRState, peer: int, gauge_mode: str = "centroid",
               cap: int = STAR_EDGES) -> StarMsg:
    """Condense my own-edge graph onto the boundary ``peer`` requested
    (``computeCondensedGraph``, own edges only), under the (owner,
    keyframe) chain permutation. ``gauge_mode``: ``"centroid"`` (default,
    ``selectGaugeCentroid``) or ``"optimal"`` (``selectOptimalGauge``: one
    condense per valid boundary vertex, batched, so K times the work:
    :func:`condensed.condense_optimal`)."""
    slam = st.slam
    g, slots, valid, own, order, n_sel = star_inputs(st, peer, cap)
    cap = slots.shape[0]
    if gauge_mode == "optimal":
        star, _ = CG.condense_optimal(g, slots, valid, own, order)
    elif gauge_mode == "centroid":
        gauge = CG.select_gauge_centroid(g, slots, valid)
        star = CG.condense(g, slots, valid, gauge, own, order)
    else:
        raise ValueError(f"unknown gauge_mode {gauge_mode!r}")
    return StarMsg(
        gauge=row(slam.v_remote, star.gauge),
        boundary=slam.v_remote[slots.long()],
        z=star.z, info=star.info,
        valid=star.valid & torch.any(valid),
        dropped=torch.clamp(n_sel - cap, min=0))


def build_graph_msg(st: MRState) -> GraphMsg:
    """My newest ≤``GRAPH_MSG_V`` own vertices and the own edges among them
    (the lowest ≤``GRAPH_MSG_E`` edge slots)."""
    slam = st.slam
    n = slam.v_owner.shape[0]
    dev = slam.v_owner.device
    slots, ok = newest_own(slam, min(GRAPH_MSG_V, n))
    s = slots.long()
    g = slam.graph
    in_win = put_drop(torch.zeros((n,), dtype=torch.bool, device=dev),
                      torch.where(ok, slots, n).long(), True)
    e = g.e_ij.long()
    e_ok = (G.own_edge_mask(g, slam.my_id) & in_win[e[:, 0]]
            & in_win[e[:, 1]])
    ar = torch.arange(e_ok.shape[0], dtype=torch.int32, device=dev)
    evals, es = first_k(torch.where(e_ok, ar, torch.full_like(ar, -1)),
                        min(GRAPH_MSG_E, e_ok.shape[0]))
    return GraphMsg(
        robot=slam.my_id, poses=g.poses[s], idxs=slam.v_remote[s],
        vvalid=ok,
        e_ij=torch.stack([slam.v_remote[e[es, 0]], slam.v_remote[e[es, 1]]],
                         dim=-1),
        e_z=g.e_z[es], e_info=g.e_info[es], evalid=evals >= 0)


def receive_graph_msg(st: MRState, msg: GraphMsg, live) -> MRState:
    """Merge a peer's full graph (``addInterRobotDataGraph``,
    ``mr_graph_slam.cpp:397-483``): instantiate its unknown vertices at
    their reported poses (without scans: the fallback ships none), then
    replace the peer's edge set wholesale (level ``1 + robot``, as a
    condensed star).

    The reference adds the vertices one at a time in message order, each
    new one taking the next slot; here an integer ``cumsum`` over the
    message gives every new vertex the same slot at once. An entry whose
    index an earlier entry of the message adds is not new (the reference
    finds the earlier one's slot) unless that earlier one fell past the
    capacity: then it is counted again, as the reference counts it."""
    slam = st.slam
    n = slam.v_owner.shape[0]
    dev = slam.v_owner.device
    live = _live(live, dev)
    robot = msg.robot.to(device=dev, dtype=torch.int32)
    idxs = msg.idxs.to(torch.int32)
    v = idxs.shape[0]
    cand = live & msg.vvalid & (find_slots(slam, robot, idxs) == n)
    earlier = torch.ones((v, v), dtype=torch.bool, device=dev).tril(-1)
    same = (idxs[:, None] == idxs[None, :]) & cand[None, :] & earlier
    repeat = same.any(1)
    first = cand & ~repeat
    g = slam.graph
    tgt = g.n_vertices + torch.cumsum(first.to(torch.int32), 0,
                                      dtype=torch.int32) - 1
    slot = torch.where(first & (tgt < n), tgt, n).long()      # n = drop
    # a repeat whose first entry was dropped at capacity is added again
    again = cand & repeat & (tgt[torch.argmax(same.to(torch.uint8), 1)] >= n)
    n_new = (first.to(torch.int32).sum() + again.to(torch.int32).sum())
    g = dataclasses.replace(
        g, poses=put_drop(g.poses, slot, msg.poses),
        vmask=put_drop(g.vmask, slot, True),
        n_vertices=(g.n_vertices + n_new).to(torch.int32))
    slam = dataclasses.replace(
        slam, graph=g, v_owner=put_drop(slam.v_owner, slot, robot),
        v_remote=put_drop(slam.v_remote, slot, idxs))

    vi = find_slots(slam, robot, msg.e_ij[:, 0])
    vj = find_slots(slam, robot, msg.e_ij[:, 1])
    ok = live & msg.evalid & (vi < n) & (vj < n)
    g = slam.graph
    level = 1 + robot
    stale = g.emask & (g.e_owner == robot) & (g.e_level == level) & live
    g = G.add_edges_masked(G.remove_edges(g, stale),
                           torch.clamp(vi, max=n - 1),
                           torch.clamp(vj, max=n - 1), msg.e_z, msg.e_info,
                           ok, level=level, owner=robot)
    return dataclasses.replace(st, slam=dataclasses.replace(slam, graph=g))


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
