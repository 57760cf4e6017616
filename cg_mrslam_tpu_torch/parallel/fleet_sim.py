"""Fleet driver: N robots, one fleet round per keyframing tick, one host
read per round.

Port of ``cg_mrslam_tpu/parallel/fleet_sim.py``. A round is every gated
robot's keyframe step plus the full combo / closure-list / star exchange
(``fleet.exchange``), all on the bucket slice that fits the fleet's live
graphs, then merged back; the packed ``[R, 11]`` info comes to the host in
one copy (on a multi-process mesh the same exchange runs as
``fleet.fleet_round_sharded``). Bucketing mirrors
``pipeline.slam.keyframe_step_bucketed`` with the bucket of the largest
live graph, since the state is stacked.

The reference computes the step of a robot whose keyframe gate did not
fire (fixed shapes) and discards it with a ``where``; here that robot
skips its step. Its state and its info row (zeros) are the same.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.mr import mrslam as MR
from cg_mrslam_tpu_torch.mr import network as NET
from cg_mrslam_tpu_torch.parallel import fleet
from cg_mrslam_tpu_torch.pipeline import slam as SL
from cg_mrslam_tpu_torch.sim import world as W

INFO_WIDTH = 9     # the packed StepInfo (pipeline.slam._pack_info)


def _slice_mr(st: MR.MRState, nb: int, eb: int) -> MR.MRState:
    """Bucket-slice one robot's FULL MR state (slam + parking + closure
    bookkeeping); mirrors ``pipeline.slam._slice_state``."""
    return dataclasses.replace(
        st, slam=SL._slice_state(st.slam, nb, eb),
        parked=st.parked[:nb], park_age=st.park_age[:nb],
        in_closures=st.in_closures[:, :nb],
        out_closures=st.out_closures[:, :nb])


def _merge_mr(full: MR.MRState, part: MR.MRState) -> MR.MRState:
    nb = part.parked.shape[0]

    def splice(a, b):
        out = a.clone()
        out[..., :nb] = b
        return out

    return dataclasses.replace(
        full, slam=SL._merge_state(full.slam, part.slam),
        parked=splice(full.parked, part.parked),
        park_age=splice(full.park_age, part.park_age),
        in_closures=splice(full.in_closures, part.in_closures),
        out_closures=splice(full.out_closures, part.out_closures),
        peer_buf=part.peer_buf)


def fleet_keyframe_round(states: MR.MRState, do, ests: torch.Tensor,
                         ranges: torch.Tensor, conn, cfg: Config,
                         nb: int, eb: int):
    """The keyframe step of every robot whose gate fired + one exchange
    round, on the ``(nb, eb)`` bucket slice.

    ``states`` is the stacked ``[R, ...]`` fleet state, ``do [R]`` (host
    bools) marks robots whose keyframe gate fired, ``ests [R,3]`` /
    ``ranges [R,B]`` their dead-reckoned estimates and scans, ``conn
    [R,R]`` this round's connectivity. Returns ``(new_states, packed
    [R, 11])`` on the states' device, where columns 0-8 are the StepInfo
    pack (zeros for a robot that did not step) and 9-10 the POST-exchange
    vertex/edge counts (the exchange itself grows the graph — foreign
    vertices, inter-robot closures, star edges — so the host's bucket
    mirror must track the post-round sizes, not the step's)."""
    do = np.asarray(do, bool)
    conn = fleet._host_conn(conn)
    rr = len(do)
    full = fleet.unstack_states(states, rr)
    # the whole round — keyframe steps AND the exchange's global matches,
    # votes and star condensations — runs on the bucket slice; foreign
    # vertices/edges the exchange adds stay inside it because the host
    # sizes nb/eb from POST-exchange counts
    part = [_slice_mr(st, nb, eb) for st in full]
    rows = []
    for r, st in enumerate(part):
        if do[r]:
            slam, info = SL.keyframe_step(st.slam, ests[r], ranges[r], cfg)
            part[r] = dataclasses.replace(st, slam=slam)
            rows.append(SL._pack_info(info))
        else:
            rows.append(ests.new_zeros((INFO_WIDTH,)))
    part = fleet.exchange(part, conn, cfg)
    merged = [_merge_mr(f, p) for f, p in zip(full, part)]
    counts = torch.stack([torch.stack([st.slam.graph.n_vertices,
                                       st.slam.graph.n_edges])
                          for st in merged]).to(torch.float32)
    return (fleet.stack_states(merged),
            torch.cat([torch.stack(rows), counts], dim=-1))


class FleetSim:
    """Host driver around :func:`fleet_keyframe_round`: dead-reckoning and
    keyframe gating per robot on the host, everything else on ``device``
    (the card unless the caller names another). ``trajectories`` (one per
    robot) replaces the simulated ones — e.g. the reference simulator's,
    to replay identical scans."""

    def __init__(self, cfg: Config, world: W.World, beams: int = 180,
                 fov: float = 2 * np.pi * 0.75, max_range: float = 8.0,
                 seed: int = 0, n_loops: int = 2,
                 odom_noise=(0.02, 0.008), width: float = 16.0,
                 height: float = 10.0, device=None, trajectories=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.R = cfg.mr.n_robots
        self.beams = beams
        self.trajs = trajectories or [
            W.simulate_robot(world, W.corridor_waypoints(width, height, r,
                                                         n_loops),
                             seed=seed + 7 * r, beams=beams, fov=fov,
                             max_range=max_range, odom_noise=odom_noise,
                             device=self.device)
            for r in range(self.R)
        ]
        self.states = fleet.stack_states([
            MR.init_mr_state(cfg, beams, self.trajs[r].gt[0],
                             self.trajs[r].ranges[0], fov, max_range,
                             my_id=r, device=self.device)
            for r in range(self.R)
        ])
        self._est = [np.asarray(t.gt[0], np.float64).copy()
                     for t in self.trajs]
        self._kf_est = [e.copy() for e in self._est]
        self.kf_gt: List[list] = [[t.gt[0]] for t in self.trajs]
        self.closure_stats = np.zeros(self.R, np.int64)
        self.round_latencies: List[float] = []
        self._n_live = np.ones(self.R, np.int64)
        self._e_live = np.zeros(self.R, np.int64)

    def _dead_reckon(self, r: int, rel):
        e = self._est[r]
        c, s = np.cos(e[2]), np.sin(e[2])
        self._est[r] = np.array([
            e[0] + c * rel[0] - s * rel[1],
            e[1] + s * rel[0] + c * rel[1],
            (e[2] + rel[2] + np.pi) % (2 * np.pi) - np.pi])

    def _buckets(self):
        # worst-case growth of one ROUND: the local keyframe step (1
        # vertex; odom + direct + full closure-buffer flush edges) plus
        # the exchange (1 foreign vertex per peer; per peer a full
        # inter-robot window flush + a replaced star)
        peers = self.R - 1
        kf_buf = (self.cfg.slam.window_loop_closure
                  * self.cfg.max_regions * SL.LC_HYPOTHESES)
        grow_e = (1 + self.cfg.max_regions + kf_buf
                  + peers * (2 * self.cfg.mr.window_mr_loop_closure
                             + self.cfg.mr.star_edges_cap))
        cap_n, cap_e = self.cfg.max_vertices, self.cfg.max_edges
        nb = SL._bucket_for(int(self._n_live.max()) + 1 + peers, cap_n)
        eb = SL._bucket_for(max(int(self._e_live.max()) + grow_e, 4 * nb),
                            cap_e)
        return nb, eb

    def _connectivity(self, t: int) -> np.ndarray:
        gt_pos = np.stack([tr.gt[min(t, len(tr.gt) - 1), :2]
                           for tr in self.trajs]).astype(np.float32)
        return NET.sim_connectivity(torch.from_numpy(gt_pos),
                                    self.cfg.mr.sim_comm_range).numpy()

    def run(self, max_ticks: int | None = None):
        cfg = self.cfg
        dev = self.device
        cuda = dev.type == "cuda"
        T = min(len(t.gt) for t in self.trajs)
        if max_ticks:
            T = min(T, max_ticks)
        for t in range(1, T):
            do = np.zeros(self.R, bool)
            for r in range(self.R):
                self._dead_reckon(r, self.trajs[r].rel_odom[t - 1])
                d = np.hypot(*(self._est[r][:2] - self._kf_est[r][:2]))
                dth = abs((self._est[r][2] - self._kf_est[r][2] + np.pi)
                          % (2 * np.pi) - np.pi)
                do[r] = (d > cfg.slam.linear_update
                         or dth > cfg.slam.angular_update) \
                    and self._n_live[r] < cfg.max_vertices - 4
            if not do.any():
                continue
            conn = self._connectivity(t)
            nb, eb = self._buckets()
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ests = torch.from_numpy(np.stack(self._est).astype(
                np.float32)).to(dev)
            ranges = torch.from_numpy(np.stack(
                [np.asarray(tr.ranges[t], np.float32)
                 for tr in self.trajs])).to(dev)
            self.states, infos = fleet_keyframe_round(
                self.states, do, ests, ranges, conn, cfg, nb, eb)
            infos = infos.cpu().numpy()          # ONE fetch for the fleet
            self.round_latencies.append(time.perf_counter() - t0)
            for r in range(self.R):
                # post-exchange sizes apply to every robot (exchange grows
                # graphs even without a local keyframe)
                self._n_live[r] = int(infos[r, INFO_WIDTH])
                self._e_live[r] = int(infos[r, INFO_WIDTH + 1])
                if not do[r]:
                    continue
                self.kf_gt[r].append(self.trajs[r].gt[t])
                self._est[r] = infos[r, :3].astype(np.float64)
                self._kf_est[r] = self._est[r].copy()
                self.closure_stats[r] += int(infos[r, 4])

    @property
    def robot_states(self):
        return fleet.unstack_states(self.states, self.R)
