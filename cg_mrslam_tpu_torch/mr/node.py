"""Per-process robot node: one robot's SLAM state and a real transport.

Port of ``cg_mrslam_tpu/mr/node.py``, the reference's deployment shape —
one ``cg_mrslam`` process per robot exchanging datagrams
(``src/cg_mrslam.cpp`` + ``src/mrslam/graph_comm.cpp``). The node owns an
``MRState`` on its device (the card by default), runs the keyframe step
(kernel K1) on observations through the bucketed ``BucketRunner``, and runs
one communication round per tick that does the work of the reference's
sender, receiver and processor threads (``graph_comm.cpp:126-208``) in
order:

1. broadcast a connectivity beacon (``comm_publisher.cpp:50-82``);
2. drain the inbox and apply each message (combo → instantiate and park,
   closure list → the boundary of the star I owe, star → splice;
   ``mr_graph_slam.cpp:118-501``);
3. retry the newest parked foreign vertex (the global search: kernel K2);
4. send a combo, and per peer a closure list and a condensed star, to every
   peer in range (the modality gate of ``robotsInRange``,
   ``graph_comm.cpp:70-101``).

Every message is fire-and-forget and idempotent (stars replace wholesale),
so loss, duplication and reordering are tolerated as in the reference. The
order of operations in :meth:`RobotNode.observe` and
:meth:`RobotNode.comm_round` is the JAX package's, so two nodes of each
package fed the same inputs exchange the same datagrams.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np
import torch

from cg_mrslam_tpu_torch.config import Config
from cg_mrslam_tpu_torch.core.scan import resample_scan_np
from cg_mrslam_tpu_torch.mr import mrslam as MR
from cg_mrslam_tpu_torch.mr import wire
from cg_mrslam_tpu_torch.pipeline.slam import BucketRunner


class RobotNode:
    """One robot's process-local endpoint. ``transport`` is anything with
    ``send(peer, bytes)``, ``drain()`` and ``close()``
    (``mr.transport.UdpTransport`` in a deployment). ``warm_start`` is
    accepted and does nothing: eager PyTorch compiles no step."""

    def __init__(self, cfg: Config, robot_id: int, beams: int,
                 initial_pose, ranges, fov: float, max_range: float,
                 transport, modality: str = "real", gt_pose=None,
                 warm_start: bool = False, device=None):
        self.cfg = cfg
        self.id = robot_id
        self.R = cfg.mr.n_robots
        self.beams = beams
        self.modality = modality
        self.transport = transport
        self.state = MR.init_mr_state(cfg, beams, initial_pose, ranges, fov,
                                      max_range, my_id=robot_id,
                                      device=device)
        self.device = self.state.slam.graph.poses.device
        s = self.state.slam.scans
        # my beam grid as host numbers (it never changes)
        self._geometry = (s.ranges.shape[1], *torch.stack(
            [s.first_beam_angle, s.angular_step, s.max_range]).tolist())
        self._est = np.asarray(initial_pose, np.float64).copy()
        self._kf_est = self._est.copy()
        self._gt = np.asarray(
            gt_pose if gt_pose is not None else initial_pose,
            np.float64).copy()
        # connectivity bookkeeping from received beacons
        self._ping_time = np.full(self.R, -np.inf)
        self._peer_pos = np.full((self.R, 2), np.inf)
        self._last_combo_sent = -1    # n_vertices at the last combo sent
        self._last_send_t = -np.inf   # sender-thread cadence
        # closure-list rotation offsets (cover an accepted set larger than
        # one list across sends, see MR.build_closure_list) and the
        # unchanged-send cache: between keyframes and receives nothing a
        # list or a star depends on changes, so the encoded datagrams are
        # reused
        self._list_off = np.zeros(self.R, np.int64)
        self._send_cache: dict = {}
        self._msg_log = None
        self._bag_events: List[Tuple[float, int]] = []
        self.ping_events: List[Tuple[float, int, int]] = []  # (t, me, src)
        self.stats = {"sent": 0, "received": 0, "keyframes": 0,
                      "decode_errors": 0, "closure_list_dropped": 0,
                      "star_dropped": 0, "keyframes_capacity_stopped": 0,
                      # datagram bytes, beacons included (the reference
                      # logs its comm bytes, graph_comm.cpp:117,164)
                      "bytes_sent": 0, "bytes_received": 0}
        self.infos = []
        # bucketed stepping, as SingleRobotSlam; exchange rounds grow the
        # graph outside observe(), so the live counts are re-read from the
        # graph before each step
        self.runner = BucketRunner(cfg)

    # ---------------------------------------------------------- sensing

    def dead_reckon(self, rel_odom) -> None:
        e = self._est
        c, s = np.cos(e[2]), np.sin(e[2])
        self._est = np.array([
            e[0] + c * rel_odom[0] - s * rel_odom[1],
            e[1] + s * rel_odom[0] + c * rel_odom[1],
            (e[2] + rel_odom[2] + np.pi) % (2 * np.pi) - np.pi])

    def keyframe_due(self) -> bool:
        d = np.hypot(*(self._est[:2] - self._kf_est[:2]))
        dth = abs((self._est[2] - self._kf_est[2] + np.pi)
                  % (2 * np.pi) - np.pi)
        return (d > self.cfg.slam.linear_update
                or dth > self.cfg.slam.angular_update)

    def observe(self, rel_odom, ranges, gt_pose=None) -> bool:
        """Dead-reckon; on a keyframe run the SLAM step, then retry a
        parked foreign vertex and vote (``cg_mrslam.cpp:206-259``). Returns
        whether a keyframe was added."""
        self.dead_reckon(rel_odom)
        if gt_pose is not None:
            self._gt = np.asarray(gt_pose, np.float64).copy()
        if not self.keyframe_due():
            return False
        g = self.state.slam.graph
        n_live, e_live = torch.stack([g.n_vertices, g.n_edges]).tolist()
        if n_live >= self.cfg.max_vertices - 4:
            # the capacity binds: counted, and dead reckoning goes on
            self.stats["keyframes_capacity_stopped"] += 1
            return False
        st = self.state
        self.runner.n_live, self.runner.e_live = n_live, e_live
        slam, info = self.runner.step(
            st.slam, np.asarray(self._est, np.float32),
            np.asarray(ranges, np.float32))
        self.state = MR.MRState(
            slam=slam, parked=st.parked, park_age=st.park_age,
            peer_buf=st.peer_buf, in_closures=st.in_closures,
            out_closures=st.out_closures)
        # the per-keyframe inter-robot pass (cg_mrslam.cpp:223): the MR
        # window ages per keyframe
        self.state = MR.try_match_parked(self.state, self.cfg)
        self.state = MR.vote_inter_robot(self.state, self.cfg)
        self._est = np.asarray(info.pose, np.float64)
        self._kf_est = self._est.copy()
        self.stats["keyframes"] += 1
        self.infos.append(info)
        return True

    # ----------------------------------------------------- connectivity

    def connected(self, peer: int, t: float) -> bool:
        """The modality gate of ``robotsInRange`` (graph_comm.cpp:70-101)."""
        if peer == self.id:
            return False
        if self.modality == "real":
            return True   # the radio decides (:74-78)
        if self.modality == "bag":
            return (t - self._ping_time[peer]
                    ) < self.cfg.mr.ping_timeout  # (:88-98)
        # sim: ground-truth distance < range (:79-87); the peer's position
        # arrives on its beacon
        if not np.isfinite(self._peer_pos[peer]).all():
            return False
        return bool(np.hypot(*(self._gt[:2] - self._peer_pos[peer]))
                    < self.cfg.mr.sim_comm_range)

    # ----------------------------------------------------------- comms

    def _to_my_geometry(self, combo: MR.Combo) -> MR.Combo:
        """A peer's scan resampled onto my beam grid when the geometries
        differ (heterogeneous lasers; the reference ships the laser's
        parameters with every message for the same reason). The resampled
        ranges go back to my device."""
        b, fba, step, maxr = self._geometry
        c_fba, c_step, c_maxr = torch.stack(
            [combo.first_beam_angle, combo.angular_step,
             combo.max_range]).tolist()
        if (combo.ranges.shape[0] == b and abs(c_fba - fba) < 1e-6
                and abs(c_step - step) < 1e-9 and abs(c_maxr - maxr) < 1e-6):
            return combo
        r = resample_scan_np(combo.ranges.cpu().numpy(), c_fba, c_step,
                             c_maxr, b, fba, step, maxr)
        s = self.state.slam.scans
        return combo._replace(ranges=torch.from_numpy(r).to(self.device),
                              first_beam_angle=s.first_beam_angle,
                              angular_step=s.angular_step,
                              max_range=s.max_range)

    def _apply(self, sender: int, msg) -> None:
        if isinstance(msg, MR.Combo):
            self.state = MR.receive_combo(
                self.state, self._to_my_geometry(msg), True)
        elif isinstance(msg, MR.ClosureList):
            self.state = MR.receive_closure_list(self.state, sender, msg,
                                                 True)
        elif isinstance(msg, MR.StarMsg):
            self.state = MR.receive_star(self.state, sender, msg, True)
        elif isinstance(msg, MR.GraphMsg):
            self.state = MR.receive_graph_msg(self.state, msg, True)

    def _send(self, peer: int, buf: bytes, t: float, data: bool) -> None:
        """Send one datagram; ``data``: a SLAM message (counted in
        ``sent``), not a beacon."""
        self.transport.send(peer, buf)
        self._log_msg("sent", peer, buf, t)
        if data:
            self.stats["sent"] += 1
        self.stats["bytes_sent"] += len(buf)

    def comm_round(self, t: float) -> None:
        """One pass of the reference's three comm threads. Receiving and
        processing run on every call (the reference's receiver blocks on
        its socket all the time); the beacon and the data sends run at the
        sender thread's cadence ``send_period`` (``graph_comm.cpp:152``)."""
        send_due = (t - self._last_send_t) >= self.cfg.mr.send_period
        if send_due:
            self._last_send_t = t
            # 1. the beacon (carries my position for the sim gate)
            ping = wire.encode(wire.Ping(self.id, float(self._gt[0]),
                                         float(self._gt[1])))
            for peer in range(self.R):
                if peer != self.id:
                    self._send(peer, ping, t, data=False)

        # 2. drain and process (receiveFromThrd / processQueueThrd)
        for buf in self.transport.drain():
            self.stats["bytes_received"] += len(buf)
            try:
                sender, msg = wire.decode(buf, beams=self.beams,
                                          device=self.device)
            except ValueError:
                self.stats["decode_errors"] += 1
                continue
            self._log_msg("recv", int(sender), buf, t)
            if isinstance(msg, wire.Ping):
                if not 0 <= msg.robot < self.R:
                    self.stats["decode_errors"] += 1
                    continue
                self._ping_time[msg.robot] = t
                self._peer_pos[msg.robot] = (msg.x, msg.y)
                self.ping_events.append((t, self.id, msg.robot))
                continue
            self.stats["received"] += 1
            self._apply(sender, msg)

        # 3. retry a parked vertex between keyframes too (the vote itself
        #    runs per keyframe, in observe())
        self.state = MR.try_match_parked(self.state, self.cfg)

        # 4. gated sends (sendToThrd, graph_comm.cpp:126-154)
        if not send_due:
            return
        peers = [p for p in range(self.R) if self.connected(p, t)]
        if not peers:
            return
        n_now = int(self.state.slam.graph.n_vertices)
        combo = (wire.encode(MR.build_combo(self.state))
                 if n_now != self._last_combo_sent else None)
        cap = self.cfg.mr.closure_list_cap
        for p in peers:
            if combo is not None:
                self._send(p, combo, t, data=True)
            # unchanged-send skip: a list and a star depend only on the
            # vote (keyframes), the messages applied (received) and the
            # rotation offset
            sig = (self.stats["keyframes"], self.stats["received"],
                   int(self._list_off[p]))
            cached = self._send_cache.get(p)
            if cached is not None and cached[0] == sig:
                _, buf_cl, cl_dropped, buf_star, star_dropped = cached
            else:
                buf_cl, cl_dropped = self._closure_list(p, cap)
                buf_star, star_dropped = self._star(p)
                self._send_cache[p] = (sig, buf_cl, cl_dropped, buf_star,
                                       star_dropped)
            self.stats["closure_list_dropped"] += cl_dropped
            self.stats["star_dropped"] += star_dropped
            if buf_cl is not None:
                self._send(p, buf_cl, t, data=True)
            if buf_star is not None:
                self._send(p, buf_star, t, data=True)
            if cl_dropped > 0:
                # the next send covers the next cap-window of the
                # accepted set (n_sel = dropped + cap)
                self._list_off[p] = ((self._list_off[p] + cap)
                                     % (cl_dropped + cap))
        if combo is not None:
            self._last_combo_sent = n_now

    def _closure_list(self, peer: int, cap: int):
        """The encoded closure list to ``peer`` (None when empty) and its
        overflow count."""
        cl = MR.build_closure_list(self.state, peer, cap=cap,
                                   off=int(self._list_off[peer]))
        dropped, any_valid = torch.stack(
            [cl.dropped.to(torch.int64),
             cl.valid.any().to(torch.int64)]).tolist()
        return (wire.encode(cl, robot=self.id) if any_valid else None,
                dropped)

    def _star(self, peer: int):
        """The encoded condensed star to ``peer`` (None when it has no
        valid edge) and its overflow count. With no boundary requested the
        star is empty by construction (``build_star`` masks every edge and
        counts no overflow), so its condense is not run."""
        if not bool(self.state.in_closures[peer].any()):
            return None, 0
        star = MR.build_star(self.state, peer,
                             gauge_mode=self.cfg.mr.gauge_mode,
                             cap=self.cfg.mr.star_edges_cap)
        dropped, any_valid = torch.stack(
            [star.dropped.to(torch.int64),
             star.valid.any().to(torch.int64)]).tolist()
        return (wire.encode(star, robot=self.id) if any_valid else None,
                dropped)

    # ------------------------------------------------- message logging

    def record_messages(self, path: str) -> None:
        """Log every sent and received datagram to ``path`` as JSONL:
        direction, wire type, peer, size and the payload in hex (the
        reference republishes its SLAM messages as ROS topics for later
        analysis, ``ros_handler.cpp:174-179,241-264``)."""
        self._msg_log = open(path, "a")

    def _log_msg(self, direction: str, peer: int, buf: bytes,
                 t: float) -> None:
        if self._msg_log is None:
            return
        mtype = (wire.HEADER.unpack_from(buf, 0)[0]
                 if len(buf) >= wire.HEADER.size else -1)
        self._msg_log.write(json.dumps({
            "t": t, "dir": direction, "me": self.id, "peer": peer,
            "type": mtype, "bytes": len(buf), "payload": buf.hex(),
        }) + "\n")

    # ------------------------------------------------------- ping logs

    def save_pings(self, path: str) -> None:
        """Write the received beacons for a later bag-modality replay (the
        reference's real runs publish their pings into the bag,
        ``ros_handler.cpp:241-264``)."""
        with open(path, "w") as f:
            for (t, hearer, sender) in self.ping_events:
                f.write(json.dumps(
                    {"t": t, "hearer": hearer, "sender": sender}) + "\n")

    def load_pings(self, path: str) -> None:
        """Load a recorded ping log for the bag gate: connectivity at time
        t follows the recorded ping ages, not live beacons."""
        self._bag_events = []
        with open(path) as f:
            for line in f:
                e = json.loads(line)
                if e["hearer"] == self.id:
                    self._bag_events.append((e["t"], e["sender"]))

    def bag_tick(self, t: float) -> None:
        """Advance the replayed ping ages up to time ``t``."""
        for (ts, sender) in self._bag_events:
            if ts <= t:
                self._ping_time[sender] = max(self._ping_time[sender], ts)

    def close(self) -> None:
        if self._msg_log is not None:
            self._msg_log.close()
            self._msg_log = None
        self.transport.close()
