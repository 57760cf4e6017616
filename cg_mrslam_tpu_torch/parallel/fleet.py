"""SPMD multi-robot deployment: robots as process shards, exchange as
collectives.

Port of ``cg_mrslam_tpu/parallel/fleet.py``. The reference distributes
robots as one UDP process per robot (``graph_comm.cpp``); here a
communication round is three build → deliver → consume phases in which
every message family (combo, closure list, condensed star) is produced by
its sender, gathered, and consumed under the connectivity mask. The wire
format is the fixed-shape message tuple itself.

Two entry points with the same semantics:

* :func:`fleet_round` — one process, robots in a loop, on the states'
  device; also the oracle for the sharded path.
* :func:`fleet_round_sharded` — multi-controller SPMD over
  ``torch.distributed``: each process holds the robot block of its rank on
  the mesh's ``robots`` dimension, builds the block's messages and gathers
  every message leaf into the full ``[R, ...]`` table with ``all_gather``.

The reference ``vmap``s every robot and builds all R×R lists and stars,
self-pairs and unconnected pairs included, and masks their consumption
with ``live``. Here only the messages that are consumed (``conn[r, s]``
true) are built and delivered; a message delivered with ``live`` false
leaves the state unchanged (``receive_combo``, ``receive_closure_list``
and ``receive_star`` are identities then), so the two agree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.convert import tree_leaves, tree_map
from cg_mrslam_tpu_torch.mr import mrslam as MR


def stack_states(states) -> MR.MRState:
    """List of per-robot MRStates → one batched state [R, ...]."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


def unstack_states(batched: MR.MRState, r: int):
    return [tree_map(lambda a: a[k], batched) for k in range(r)]


def _host_conn(conn) -> np.ndarray:
    """The connectivity mask on the host (one read when it is a device
    tensor): which messages are built and consumed is decided there."""
    if isinstance(conn, torch.Tensor):
        conn = conn.cpu().numpy()
    return np.asarray(conn, bool)


def _combo_phase(states: list, combos: dict, conn: np.ndarray,
                 cfg: Config, gids) -> list:
    """Robot ``gids[k]`` (holding ``states[k]``) receives the combos of
    row ``conn[gid]`` in sender order, then matches and votes."""
    out = []
    for st, gid in zip(states, gids):
        for s in range(conn.shape[1]):
            if conn[gid, s]:
                st = MR.receive_combo(st, combos[s], True)
        st = MR.try_match_parked(st, cfg)
        out.append(MR.vote_inter_robot(st, cfg))
    return out


def _consume(states: list, msgs: dict, conn: np.ndarray, gids,
             receive) -> list:
    """Robot ``gid`` takes the messages ``msgs[(src, gid)]`` in sender
    order through ``receive`` (``receive_closure_list`` or
    ``receive_star``)."""
    out = []
    for st, gid in zip(states, gids):
        for src in range(conn.shape[1]):
            if conn[gid, src]:
                st = receive(st, src, msgs[(src, gid)], True)
        out.append(st)
    return out


def _build(states: list, conn: np.ndarray, gids, build, cap: int,
           **kw) -> dict:
    """``(src, dst) → build(state of src, dst, cap, **kw)`` for every
    consumed pair whose sender ``src`` is in ``gids``
    (``build_closure_list`` or ``build_star``)."""
    return {(src, dst): build(st, dst, cap=cap, **kw)
            for st, src in zip(states, gids)
            for dst in range(conn.shape[0]) if conn[dst, src]}


def exchange(states: list, conn: np.ndarray, cfg: Config) -> list:
    """One synchronous exchange round over per-robot states (robot ``r``
    holds ``states[r]``)."""
    gids = range(len(states))
    combos = {s: MR.build_combo(st) for s, st in enumerate(states)
              if conn[:, s].any()}
    states = _combo_phase(states, combos, conn, cfg, gids)
    lists = _build(states, conn, gids, MR.build_closure_list,
                   cfg.mr.closure_list_cap)
    states = _consume(states, lists, conn, gids, MR.receive_closure_list)
    stars = _build(states, conn, gids, MR.build_star, cfg.mr.star_edges_cap,
                   gauge_mode=cfg.mr.gauge_mode)
    return _consume(states, stars, conn, gids, MR.receive_star)


def fleet_round(states: MR.MRState, conn, cfg: Config) -> MR.MRState:
    """One synchronous exchange round, batched over robots [R, ...].

    Three build→deliver→consume phases IN ORDER — closure lists are built
    AFTER this round's votes, and stars AFTER this round's list
    deliveries, exactly like the host-loop harness (``mr.sim``) and the
    reference's processing cadence. Building all three tables up front
    would lag lists/stars one round behind and the trajectories diverge.
    Only consumed messages are built (see the module docstring)."""
    conn = _host_conn(conn)
    rr = conn.shape[0]
    return stack_states(exchange(unstack_states(states, rr), conn, cfg))


# ----------------------------------------------------------- the sharded round


def _blank_list(st: MR.MRState, cap: int) -> MR.ClosureList:
    """A closure list nobody consumes: its table slot, with the shapes and
    dtypes :func:`mrslam.build_closure_list` gives."""
    dev = st.parked.device
    cap = min(cap, st.parked.shape[0])
    return MR.ClosureList(
        idxs=torch.zeros((cap,), dtype=torch.int32, device=dev),
        valid=torch.zeros((cap,), dtype=torch.bool, device=dev),
        dropped=torch.zeros((), dtype=torch.int64, device=dev))


def _blank_star(st: MR.MRState, cap: int) -> MR.StarMsg:
    """A star nobody consumes (the shapes and dtypes of
    :func:`mrslam.build_star`)."""
    dev = st.parked.device
    cap = min(cap, st.parked.shape[0])
    z = st.slam.graph.e_z
    return MR.StarMsg(
        gauge=torch.zeros((), dtype=torch.int32, device=dev),
        boundary=torch.zeros((cap,), dtype=torch.int32, device=dev),
        z=torch.zeros((cap, 3), dtype=z.dtype, device=dev),
        info=torch.zeros((cap, 6), dtype=z.dtype, device=dev),
        valid=torch.zeros((cap,), dtype=torch.bool, device=dev),
        dropped=torch.zeros((), dtype=torch.int64, device=dev))


def _gather_table(msgs: list, like, group) -> list:
    """All-gather one message per table slot of this rank (``msgs``, in
    slot order) into every rank's full table, returned as a list of
    messages in global slot order. Every leaf must have the shape and dtype
    of ``like``'s (fixed-shape messages: the collective needs equal sizes
    on every rank); bools travel as uint8."""
    n = dist.get_world_size(group)
    cols = []
    for k, ref in enumerate(tree_leaves(like)):
        leaves = [tree_leaves(m)[k] for m in msgs]
        for leaf in leaves:
            assert leaf.shape == ref.shape and leaf.dtype == ref.dtype, (
                f"message leaf {k}: {tuple(leaf.shape)} {leaf.dtype}, "
                f"expected {tuple(ref.shape)} {ref.dtype}")
        local = torch.stack(leaves)
        if local.dtype == torch.bool:
            local = local.to(torch.uint8)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local.contiguous(), group=group)
        cols.append(torch.cat(parts).to(ref.dtype))
    rows = []
    for i in range(cols[0].shape[0]):
        it = iter(c[i] for c in cols)
        rows.append(tree_map(lambda _: next(it), like))
    return rows


def _gather_pairs(built: dict, blank, gids, rr: int, group) -> dict:
    """``(src, dst) → message`` for every pair of the fleet: this rank's
    senders' ``built`` messages (``blank`` where nobody consumes one),
    gathered from every rank; slot (src, dst) of the table is src·R + dst."""
    table = _gather_table([built.get((src, dst), blank) for src in gids
                           for dst in range(rr)], blank, group)
    return {(src, dst): table[src * rr + dst]
            for src in range(rr) for dst in range(rr)}


def fleet_round_sharded(states: MR.MRState, conn, cfg: Config,
                        mesh) -> MR.MRState:
    """Same round as a multi-controller SPMD program over the mesh's
    ``robots`` dimension (a ``torch.distributed.device_mesh.DeviceMesh``).

    ``states`` is this rank's robot block ``[loc, ...]`` (robots
    ``rank·loc .. rank·loc + loc - 1``), ``conn`` the full ``[R, R]`` mask
    (the same on every rank). Each phase builds the block's messages, the
    tables are gathered with ``all_gather``, and each robot consumes its
    column under ``conn``. Table slots nobody consumes travel as blank
    messages of the same shape. Returns the local block."""
    conn = _host_conn(conn)
    rr = conn.shape[0]
    group = mesh.get_group("robots")
    me = mesh.get_local_rank("robots")
    n = mesh.size(mesh.mesh_dim_names.index("robots"))
    loc = states.parked.shape[0]
    assert loc * n == rr, (loc, n, rr)
    gids = list(range(me * loc, (me + 1) * loc))
    local = unstack_states(states, loc)

    # phase 1: combos — every robot's, gathered, consumed per robot
    mine = [MR.build_combo(st) for st in local]
    combos = dict(enumerate(_gather_table(mine, mine[0], group)))
    local = _combo_phase(local, combos, conn, cfg, gids)

    # phase 2: closure lists built from the POST-vote state
    cap = cfg.mr.closure_list_cap
    lists = _gather_pairs(_build(local, conn, gids, MR.build_closure_list,
                                 cap),
                          _blank_list(local[0], cap), gids, rr, group)
    local = _consume(local, lists, conn, gids, MR.receive_closure_list)

    # phase 3: stars built from the POST-list state
    cap = cfg.mr.star_edges_cap
    stars = _gather_pairs(_build(local, conn, gids, MR.build_star, cap,
                                 gauge_mode=cfg.mr.gauge_mode),
                          _blank_star(local[0], cap), gids, rr, group)
    return stack_states(_consume(local, stars, conn, gids, MR.receive_star))
