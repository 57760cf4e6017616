"""Deterministic multi-robot SLAM harness: N robots, one process.

Port of ``cg_mrslam_tpu/mr/sim.py`` (the ``cg_mrslam`` command's in-process
deployment): each robot runs the single-robot keyframe step on its own
state, and after every tick in which some robot keyframed, one synchronous
exchange round delivers combo / closure-list / star messages between all
connected pairs (connectivity from ``mr.network``). Runs on the card unless
``device`` names another device.

As in the reference, the step runs on the whole state (no bucketing); each
keyframe fetches its ``StepInfo`` in one device-to-host copy.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.mr import mrslam as MR
from cg_mrslam_tpu_torch.mr import network as NET
from cg_mrslam_tpu_torch.pipeline.slam import (_pack_info, _unpack_info,
                                               keyframe_step)
from cg_mrslam_tpu_torch.sim import world as W


class MultiRobotSim:
    """Host loop for R robots over one shared world."""

    def __init__(self, cfg: Config, world: W.World, beams: int = 180,
                 fov: float = 2 * np.pi * 0.75, max_range: float = 8.0,
                 seed: int = 0, n_loops: int = 2,
                 odom_noise=(0.02, 0.008), width: float = 16.0,
                 height: float = 10.0, device=None, trajectories=None):
        """``trajectories`` (one per robot) replaces the simulated ones —
        e.g. the reference simulator's, to replay identical scans."""
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
        self.states: List[MR.MRState] = [
            MR.init_mr_state(cfg, beams, self.trajs[r].gt[0],
                             self.trajs[r].ranges[0], fov, max_range,
                             my_id=r, device=self.device)
            for r in range(self.R)
        ]
        self._est = [np.asarray(t.gt[0], np.float64).copy()
                     for t in self.trajs]
        self._kf_est = [e.copy() for e in self._est]
        self.kf_gt = [[t.gt[0]] for t in self.trajs]
        self.closure_stats = np.zeros(self.R, np.int64)
        self.infos: List[list] = [[] for _ in range(self.R)]
        # fault injection: per-round probability of dropping a live link
        # (the reference's UDP drops silently; the protocol must converge)
        self.drop_prob = 0.0
        self._drop_rng = np.random.default_rng(seed + 999)
        self.ping_log = None  # NET.PingLog for bag modality
        self._tick = 1  # resume cursor: run() continues where it left off

    def _dead_reckon(self, r: int, rel):
        e = self._est[r]
        c, s = np.cos(e[2]), np.sin(e[2])
        self._est[r] = np.array([
            e[0] + c * rel[0] - s * rel[1],
            e[1] + s * rel[0] + c * rel[1],
            (e[2] + rel[2] + np.pi) % (2 * np.pi) - np.pi])

    def keyframe(self, r: int, t: int):
        """Robot ``r``'s keyframe at tick ``t``: the step on its state, the
        ``StepInfo`` fetched to the host."""
        st = self.states[r]
        dev = self.device
        est = torch.tensor(self._est[r], dtype=torch.float32, device=dev)
        ranges = torch.tensor(np.asarray(self.trajs[r].ranges[t]),
                              dtype=torch.float32, device=dev)
        slam, info = keyframe_step(st.slam, est, ranges, self.cfg)
        self.states[r] = MR.MRState(
            slam=slam, parked=st.parked, park_age=st.park_age,
            peer_buf=st.peer_buf, in_closures=st.in_closures,
            out_closures=st.out_closures)
        return _unpack_info(_pack_info(info).cpu().numpy())

    def run(self, max_ticks: int | None = None, modality: str = "sim"):
        cfg = self.cfg
        T = min(len(t.gt) for t in self.trajs)
        if max_ticks:
            T = min(T, max_ticks)
        start = self._tick
        self._tick = max(self._tick, T)
        for t in range(start, T):
            keyframed = []
            for r in range(self.R):
                self._dead_reckon(r, self.trajs[r].rel_odom[t - 1])
                d = np.hypot(*(self._est[r][:2] - self._kf_est[r][:2]))
                dth = abs((self._est[r][2] - self._kf_est[r][2] + np.pi)
                          % (2 * np.pi) - np.pi)
                if (d <= cfg.slam.linear_update
                        and dth <= cfg.slam.angular_update):
                    continue
                if int(self.states[r].slam.graph.n_vertices) \
                        >= cfg.max_vertices - 4:
                    continue
                info = self.keyframe(r, t)
                self.infos[r].append(info)
                self.kf_gt[r].append(self.trajs[r].gt[t])
                self._est[r] = np.asarray(info.pose, np.float64)
                self._kf_est[r] = self._est[r].copy()
                self.closure_stats[r] += int(info.closures_added)
                keyframed.append(r)
            if keyframed:
                self.exchange_round(t, modality)

    def connectivity(self, t: int, modality: str) -> np.ndarray:
        if modality == "real":
            conn = NET.real_connectivity(self.R).numpy()
        elif modality == "bag":
            if self.ping_log is None:
                raise ValueError("bag modality needs a PingLog")
            # ping logs are in seconds (10 Hz main loop)
            conn = self.ping_log.connectivity(
                0.1 * float(t), self.cfg.mr.ping_timeout).numpy()
        else:
            gt_pos = np.stack([tr.gt[min(t, len(tr.gt) - 1), :2]
                               for tr in self.trajs]).astype(np.float32)
            conn = NET.sim_connectivity(torch.from_numpy(gt_pos),
                                        self.cfg.mr.sim_comm_range).numpy()
        if self.drop_prob > 0.0:
            conn = conn & (self._drop_rng.random(conn.shape)
                           >= self.drop_prob)
        return conn

    def exchange_round(self, t: int, modality: str = "sim"):
        """One synchronous message round between all connected pairs."""
        conn = self.connectivity(t, modality)
        cfg = self.cfg

        combos = [MR.build_combo(st) for st in self.states]
        for r in range(self.R):
            for s in range(self.R):
                if r != s and conn[r, s]:
                    self.states[r] = MR.receive_combo(self.states[r],
                                                      combos[s], True)
        for r in range(self.R):
            self.states[r] = MR.try_match_parked(self.states[r], cfg)
            self.states[r] = MR.vote_inter_robot(self.states[r], cfg)

        lists = {}
        for r in range(self.R):
            for s in range(self.R):
                if r != s and conn[r, s]:
                    lists[(s, r)] = MR.build_closure_list(
                        self.states[r], s, cap=cfg.mr.closure_list_cap)
        for (dst, src), cl in lists.items():
            self.states[dst] = MR.receive_closure_list(self.states[dst],
                                                       src, cl, True)

        stars = {}
        for r in range(self.R):
            for s in range(self.R):
                if r != s and conn[r, s]:
                    stars[(s, r)] = MR.build_star(
                        self.states[r], s, gauge_mode=cfg.mr.gauge_mode,
                        cap=cfg.mr.star_edges_cap)
        for (dst, src), msg in stars.items():
            self.states[dst] = MR.receive_star(self.states[dst], src, msg,
                                               True)
