"""Command line: ``srslam`` and ``cg_mrslam`` (all robots in one process, or
one robot per process over UDP).

Port of ``cg_mrslam_tpu/cli.py``, with the same flags (the reference
binaries' ``-resolution -maxScore -minInliers -windowLoopClosure
-inlierThreshold -angularUpdate -linearUpdate -nRobots -maxScoreMR
-minInliersMR -windowMRLoopClosure -modality -o``), driving the synthetic
hospital world or a CARMEN log. It writes the reference's artifacts into
the working directory: ``robot-<r>-<o>.g2o`` graphs, ``robot-<r>-<o>-map``
``.pgm/.yaml`` occupancy maps and, for ``srslam``, the metrics JSONL.

Usage (on the card; there is no device flag):

    python -m cg_mrslam_tpu_torch srslam -o out --ticks 800
    python -m cg_mrslam_tpu_torch srslam --load robot-0-out.g2o -o more
    python -m cg_mrslam_tpu_torch srslam --carmen log.clf -o log
    python -m cg_mrslam_tpu_torch cg_mrslam --nRobots 2 --modality sim -o mr
    python -m cg_mrslam_tpu_torch cg_mrslam --gauge-mode optimal -o mr
    python -m cg_mrslam_tpu_torch cg_mrslam --idRobot 0 --nRobots 2 -o udp &
    python -m cg_mrslam_tpu_torch cg_mrslam --idRobot 1 --nRobots 2 -o udp

With ``--idRobot r`` (r ≥ 0) the process runs robot r alone and exchanges
datagrams with its peers (``--baseAddr``, ``--basePort``; the native UDP
transport, which raises when it cannot be built or bound), paced to wall
time by ``--tick-seconds`` from ``--start-at``. ``main(argv, device="cpu")``
runs the same on the CPU (the tests do). ``--gauge-mode optimal`` gives
every star the uncertainty-minimizing gauge (``MRConfig.gauge_mode``), in
process and per ``--idRobot`` alike.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import threading

import numpy as np
import torch


def _host(obj):
    """A dataclass of tensors with every tensor copied to the CPU."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu()
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _ids(slam_state, cfg) -> np.ndarray:
    """g2o ids of the slots: ``runningId + robotId·baseId``
    (``graph_slam.cpp:155``)."""
    vo = slam_state.v_owner.cpu().numpy().astype(np.int64)
    vr = slam_state.v_remote.cpu().numpy().astype(np.int64)
    return vr + vo * cfg.slam.base_id


class _Checkpoints:
    """The per-keyframe ``.g2o`` save (``--save-every-keyframe``; the
    reference rewrites the graph file after every keyframe,
    ``cg_mrslam.cpp:228-230``). The state is copied to the host here (that
    copy is the checkpoint); the file is written on a background thread,
    with at most one write in flight, so the keyframe loop never waits on
    the disk."""

    def __init__(self):
        self.thread = None

    def save(self, slam_state, cfg, name: str, robot_id: int = 0) -> None:
        from cg_mrslam_tpu_torch.io import g2o

        args = (f"robot-{robot_id}-{name}.g2o", _host(slam_state.graph))
        kwargs = dict(ids=_ids(slam_state, cfg), scans=_host(slam_state.scans))
        self.join()
        self.thread = threading.Thread(target=g2o.save, args=args,
                                       kwargs=kwargs, daemon=True)
        self.thread.start()

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None


def _common_flags(p: argparse.ArgumentParser):
    p.add_argument("-o", default="out", help="output name stem")
    p.add_argument("--warm-start", action="store_true", dest="warm_start",
                   help="accepted so that the reference's command lines "
                        "run unchanged; it does nothing here: eager "
                        "PyTorch has no compile step to warm")
    p.add_argument("--save-every-keyframe", action="store_true",
                   help="rewrite the .g2o checkpoint after every keyframe "
                        "(the reference's cadence, cg_mrslam.cpp:228-230) "
                        "on a background thread")
    p.add_argument("--resolution", type=float, default=0.025,
                   help="close-matcher grid resolution [m]")
    p.add_argument("--maxScore", type=float, default=0.15)
    p.add_argument("--minInliers", type=int, default=7)
    p.add_argument("--windowLoopClosure", type=int, default=10)
    p.add_argument("--inlierThreshold", type=float, default=2.0)
    p.add_argument("--angularUpdate", type=float, default=math.pi / 4)
    p.add_argument("--linearUpdate", type=float, default=0.25)
    # the simulated sensors
    p.add_argument("--world-width", type=float, default=40.0)
    p.add_argument("--world-height", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beams", type=int, default=360)
    p.add_argument("--max-range", type=float, default=10.0)
    p.add_argument("--loops", type=int, default=2)
    p.add_argument("--ticks", type=int, default=0,
                   help="limit simulation ticks (0 = full route)")
    p.add_argument("--odom-noise", type=float, nargs=2,
                   default=(0.01, 0.004))
    p.add_argument("--max-vertices", type=int, default=512)
    p.add_argument("--max-edges", type=int, default=2048)
    # the map (cg_mrslam.cpp:109-117; the reference's live runs fill
    # invalid beams to 5 m, :134)
    p.add_argument("--map-resolution", type=float, default=0.05)
    p.add_argument("--occupied-threshold", type=float, default=0.65)
    p.add_argument("--free-threshold", type=float, default=0.196)
    p.add_argument("--map-gain", type=float, default=3.0)
    p.add_argument("--square-size", type=int, default=0)
    p.add_argument("--map-angle", type=float, default=0.0,
                   help="map base rotation [rad] (reference default pi/2)")
    p.add_argument("--usable-range", type=float, default=-1.0)
    p.add_argument("--infinity-filling-range", type=float, default=5.0)
    p.add_argument("--no-map", action="store_true")


def _build_config(a, n_robots: int = 1):
    from cg_mrslam_tpu_torch.config import (Config, MapConfig,
                                            MatcherConfig, MRConfig,
                                            SlamConfig)

    return Config(
        slam=SlamConfig(
            linear_update=a.linearUpdate, angular_update=a.angularUpdate,
            min_inliers=a.minInliers,
            window_loop_closure=a.windowLoopClosure,
            inlier_threshold=a.inlierThreshold),
        mr=MRConfig(
            n_robots=n_robots,
            max_score_mr=getattr(a, "maxScoreMR", 0.15),
            min_inliers_mr=getattr(a, "minInliersMR", 5),
            window_mr_loop_closure=getattr(a, "windowMRLoopClosure", 10),
            sim_comm_range=getattr(a, "commRange", 5.0),
            gauge_mode=getattr(a, "gauge_mode", "centroid")),
        map=MapConfig(
            resolution=a.map_resolution,
            occupied_threshold=a.occupied_threshold,
            free_threshold=a.free_threshold,
            gain=a.map_gain, square_size=a.square_size,
            angle=a.map_angle, usable_range=a.usable_range,
            infinity_filling_range=a.infinity_filling_range),
        close_matcher=MatcherConfig(
            extent=30.0, resolution=a.resolution, kernel_radius=0.2,
            max_score=a.maxScore),
        lc_matcher=MatcherConfig(
            extent=70.0, resolution=0.1, kernel_radius=0.5,
            max_score=a.maxScore),
        max_vertices=a.max_vertices,
        max_edges=a.max_edges,
    )


def _save_outputs(name: str, slam_state, cfg, a, robot_id: int = 0):
    """The run's graph file and (unless ``--no-map``) its occupancy map."""
    from cg_mrslam_tpu_torch.io import g2o
    from cg_mrslam_tpu_torch.maps import occupancy as OCC

    path = f"robot-{robot_id}-{name}.g2o"
    g2o.save(path, slam_state.graph, ids=_ids(slam_state, cfg),
             scans=slam_state.scans)
    print(f"wrote {path}")
    if a.no_map:
        return
    mc = cfg.map
    g = slam_state.graph
    poses_np = g.poses.cpu().numpy()[g.vmask.cpu().numpy()]
    if mc.angle != 0.0:  # bounding box of the rotated poses
        c, s = math.cos(mc.angle), math.sin(mc.angle)
        x, y = poses_np[:, 0].copy(), poses_np[:, 1].copy()
        poses_np = poses_np.copy()
        poses_np[:, 0] = c * x - s * y
        poses_np[:, 1] = s * x + c * y
    center = OCC.map_center(poses_np, pad=a.max_range)
    span = (poses_np[:, :2].max(0) - poses_np[:, :2].min(0)).max() \
        + 2 * a.max_range
    cells = int(np.ceil(span / mc.resolution / 128.0)) * 128
    grid = OCC.integrate(
        g.poses, slam_state.scans,
        torch.as_tensor(center, device=g.poses.device), cells=cells,
        resolution=mc.resolution, max_range=a.max_range,
        usable_range=mc.usable_range, gain=mc.gain,
        square_size=mc.square_size,
        infinity_filling_range=mc.infinity_filling_range,
        angle=mc.angle, robot_fill=mc.robot_fill)
    tri = OCC.threshold(grid, occupied_threshold=mc.occupied_threshold,
                        free_threshold=mc.free_threshold).cpu().numpy()
    OCC.save_pgm_yaml(f"robot-{robot_id}-{name}-map", tri, center,
                      mc.resolution)
    print(f"wrote robot-{robot_id}-{name}-map.pgm/.yaml")


def cmd_srslam(argv, device=None) -> int:
    p = argparse.ArgumentParser(prog="srslam")
    _common_flags(p)
    p.add_argument("--load", default=None,
                   help="resume from a .g2o checkpoint")
    p.add_argument("--carmen", default=None,
                   help="replay a CARMEN .clf log instead of the "
                        "synthetic world")
    a = p.parse_args(argv)

    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = _build_config(a)
    if a.carmen:
        from cg_mrslam_tpu_torch.io import carmen

        log = carmen.read(a.carmen, beams=a.beams, max_range=a.max_range)
        # a log's geometry is explicit (start angle, beam spacing, the
        # base→laser offset), and its noisy odometry is the initial
        # estimate: a log carries no ground truth
        init_pose = log.odom[0]
        rel_seq = log.rel_odom()
        ranges_seq = log.ranges
        slam_kw = dict(
            fov=log.fov, max_range=log.max_range,
            laser_offset=tuple(log.laser_offset()),
            first_beam_angle=log.start_angle,
            angular_step=log.angular_step)
        beams = log.ranges.shape[1]
    else:
        world = W.hospital_world(a.world_width, a.world_height,
                                 seed=a.seed)
        wps = W.corridor_waypoints(a.world_width, a.world_height, 0,
                                   a.loops)
        fov = 2 * np.pi * 0.75
        traj = W.simulate_robot(world, wps, seed=a.seed + 1,
                                beams=a.beams, fov=fov,
                                max_range=a.max_range,
                                odom_noise=tuple(a.odom_noise),
                                device=device)
        init_pose = traj.gt[0]
        rel_seq = traj.rel_odom
        ranges_seq = traj.ranges
        slam_kw = dict(fov=fov, max_range=a.max_range)
        beams = a.beams
    if a.load:
        slam = SingleRobotSlam.resume(cfg, a.load, device=device)
        print(f"resumed from {a.load}: {slam.runner.n_live} vertices")
    else:
        slam = SingleRobotSlam(cfg, beams, init_pose, ranges_seq[0],
                               device=device, **slam_kw)
    checkpoints = _Checkpoints()
    T = len(ranges_seq) if not a.ticks else min(a.ticks, len(ranges_seq))
    for t in range(1, T):
        if slam.observe(rel_seq[t - 1], ranges_seq[t]):
            i = slam.infos[-1]
            print(f"keyframe {slam.runner.n_live - 1}: "
                  f"sm={int(i.sm_accepted)} closures=+{int(i.closures_added)} "
                  f"chi2={float(i.chi2):.2f}")
            if a.save_every_keyframe:
                checkpoints.save(slam.state, cfg, a.o)
        if slam.runner.n_live >= cfg.max_vertices - 2:
            print("vertex capacity reached; stopping")
            break
    checkpoints.join()
    _save_outputs(a.o, slam.state, cfg, a)
    slam.metrics.to_jsonl(f"robot-0-{a.o}-metrics.jsonl")
    print("metrics:", json.dumps(slam.metrics.summary()))
    return 0


def _run_udp_node(a, device=None) -> int:
    """One robot per process over UDP — the reference's deployment shape
    (N ``cg_mrslam`` processes, datagrams between them). Every process
    builds the same seeded world, so the trajectories agree without a
    shared simulator."""
    from cg_mrslam_tpu_torch.mr.node import RobotNode
    from cg_mrslam_tpu_torch.mr.transport import UdpTransport
    from cg_mrslam_tpu_torch.sim import world as W

    r = a.idRobot
    cfg = _build_config(a, n_robots=a.nRobots)
    world = W.hospital_world(a.world_width, a.world_height, seed=a.seed)
    fov = 2 * np.pi * 0.75
    traj = W.simulate_robot(
        world, W.corridor_waypoints(a.world_width, a.world_height, r,
                                    a.loops),
        seed=a.seed + 7 * r, beams=a.beams, fov=fov, max_range=a.max_range,
        odom_noise=tuple(a.odom_noise), device=device)
    transport = UdpTransport(r, a.nRobots, base_addr=a.baseAddr,
                             base_port=a.basePort)
    try:
        node = RobotNode(cfg, r, a.beams, traj.gt[0], traj.ranges[0], fov,
                         a.max_range, transport, modality=a.modality,
                         gt_pose=traj.gt[0], warm_start=a.warm_start,
                         device=device)
    except BaseException:
        transport.close()
        raise
    try:
        return _udp_loop(a, cfg, r, traj, node)
    finally:
        node.close()


def _udp_loop(a, cfg, r, traj, node) -> int:
    import time

    transport = node.transport
    if a.modality == "bag":
        node.load_pings(a.pings)
    if a.record_msgs:
        node.record_messages(a.record_msgs)
    print(f"robot {r}/{a.nRobots} on "
          f"{transport.my_addr[0]}:{transport.my_addr[1]} "
          f"({'native' if transport.native else 'python'} transport, "
          f"modality {a.modality}, device {node.device.type})", flush=True)
    checkpoints = _Checkpoints()
    T = len(traj.gt) if not a.ticks else min(a.ticks, len(traj.gt))
    t_wall = a.start_at or time.time()
    if t_wall > time.time():
        time.sleep(t_wall - time.time())
    ran = 0
    for t in range(1, T):
        ran = t
        if a.tick_seconds > 0:
            lag = t_wall + t * a.tick_seconds - time.time()
            if lag > 0:
                time.sleep(lag)
        now = 0.1 * t  # the 10 Hz main loop (cg_mrslam.cpp:206)
        if a.modality == "bag":
            node.bag_tick(now)
        kf = node.observe(traj.rel_odom[t - 1], traj.ranges[t],
                          gt_pose=traj.gt[t])
        node.comm_round(now)
        n_v = int(node.state.slam.graph.n_vertices)
        if kf:
            print(f"t={t} keyframe {n_v - 1} sent={node.stats['sent']} "
                  f"recv={node.stats['received']}", flush=True)
            if a.save_every_keyframe:
                checkpoints.save(node.state.slam, cfg, a.o, robot_id=r)
        if n_v >= cfg.max_vertices - 4:
            print("vertex capacity reached; stopping")
            break
    checkpoints.join()
    loop_s = time.time() - t_wall
    print(f"{ran} ticks in {loop_s:.1f}s "
          f"({1e3 * loop_s / max(ran, 1):.1f} ms a tick)", flush=True)
    # the tail: peers may still be sending, and the condensed exchange
    # needs round trips (closure list → the peer condenses → star →
    # splice), so the comm loop runs on past the last tick
    for k in range(60):
        node.comm_round(0.1 * T + 0.1 * k)
        time.sleep(0.25)
    print(f"done in {time.time() - t_wall:.1f}s; stats={node.stats}")
    if a.record_pings:
        node.save_pings(a.record_pings)
        print(f"wrote {a.record_pings}")
    if a.stats_json:
        st = node.state
        g = st.slam.graph
        vm, vo = g.vmask.cpu().numpy(), st.slam.v_owner.cpu().numpy()
        em, lvl = g.emask.cpu().numpy(), g.e_level.cpu().numpy()
        out = dict(
            node.stats, robot=r, n_robots=a.nRobots,
            backend=node.device.type,
            transport="native" if transport.native else "python",
            n_vertices=int(g.n_vertices), n_edges=int(g.n_edges),
            foreign_vertices=int(np.sum(vm & (vo != r))),
            inter_robot_accepted=int(st.out_closures.sum()),
            condensed_star_edges_in=int(np.sum(
                em & (lvl > 0) & (g.e_owner.cpu().numpy() != r))),
            wall_s=round(time.time() - t_wall, 1))
        with open(a.stats_json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {a.stats_json}")
    _save_outputs(a.o, node.state.slam, cfg, a, robot_id=r)
    return 0


def cmd_cg_mrslam(argv, device=None) -> int:
    from cg_mrslam_tpu_torch.config import GAUGE_MODES

    p = argparse.ArgumentParser(prog="cg_mrslam")
    _common_flags(p)
    p.add_argument("--nRobots", type=int, default=2)
    p.add_argument("--maxScoreMR", type=float, default=0.15)
    p.add_argument("--minInliersMR", type=int, default=5)
    p.add_argument("--windowMRLoopClosure", type=int, default=10)
    p.add_argument("--modality", choices=("sim", "real", "bag"),
                   default="sim")
    p.add_argument("--commRange", type=float, default=5.0)
    p.add_argument("--gauge-mode", choices=GAUGE_MODES,
                   default="centroid", dest="gauge_mode",
                   help="the condensed star's gauge: the boundary vertex "
                        "nearest the boundary's centroid, or the one whose "
                        "star has the least total uncertainty (one "
                        "condense per boundary vertex)")
    # the per-process deployment (the reference's shape: one cg_mrslam
    # process per robot, UDP between them — cg_mrslam.cpp + graph_comm)
    p.add_argument("--idRobot", type=int, default=-1,
                   help="run ONE robot in this process over UDP "
                        "(-1 = all robots in this process)")
    p.add_argument("--baseAddr", default="127.0.0.1",
                   help="peer base address; a trailing '.' uses the "
                        "reference's scheme baseAddr+(id+1) "
                        "(graph_comm.cpp:41-51)")
    p.add_argument("--basePort", type=int, default=42001)
    p.add_argument("--pings", default=None,
                   help="recorded ping log (JSONL) for bag modality")
    p.add_argument("--record-pings", default=None,
                   help="write the received beacons for a later bag replay")
    p.add_argument("--record-msgs", default=None,
                   help="JSONL log of every sent and received datagram "
                        "(the reference's message republishing, "
                        "ros_handler.cpp:174-179)")
    p.add_argument("--stats-json", default=None,
                   help="write the node's end-of-run stats (keyframes, "
                        "messages, bytes, capacity counters) as JSON")
    p.add_argument("--tick-seconds", type=float, default=0.0,
                   help="pace the main loop to wall time: tick t starts no "
                        "earlier than start + t*X (free-running processes "
                        "advance their simulated clocks at different "
                        "speeds; the reference's 10 Hz loop is real time, "
                        "cg_mrslam.cpp:206)")
    p.add_argument("--start-at", type=float, default=0.0,
                   help="wall-clock time (seconds since the epoch) of tick 0 "
                        "of the main loop (0 = at once): processes given "
                        "the same start and --tick-seconds keep their "
                        "simulated clocks together from the first tick")
    a = p.parse_args(argv)

    if a.modality == "bag" and not a.pings:
        print("bag modality needs --pings", file=sys.stderr)
        return 2
    if a.idRobot >= 0:
        return _run_udp_node(a, device)

    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = _build_config(a, n_robots=a.nRobots)
    world = W.hospital_world(a.world_width, a.world_height, seed=a.seed)
    sim = MultiRobotSim(cfg, world, beams=a.beams,
                        max_range=a.max_range, seed=a.seed,
                        n_loops=a.loops, odom_noise=tuple(a.odom_noise),
                        width=a.world_width, height=a.world_height,
                        device=device)
    if a.modality == "bag":
        from cg_mrslam_tpu_torch.mr.network import PingLog

        pl = PingLog(a.nRobots)
        with open(a.pings) as f:
            for line in f:
                e = json.loads(line)
                pl.record(e["t"], e["hearer"], e["sender"])
        sim.ping_log = pl
    sim.run(max_ticks=a.ticks or None, modality=a.modality)
    for r in range(a.nRobots):
        st = sim.states[r]
        print(f"robot {r}: vertices={int(st.slam.graph.n_vertices)} "
              f"closures={int(sim.closure_stats[r])} "
              f"inter-robot accepted={int(st.out_closures.sum())}")
        _save_outputs(a.o, st.slam, cfg, a, robot_id=r)
    return 0


def main(argv=None, device=None) -> int:
    """Run a command line; ``device`` (the card by default) is for callers
    in Python, e.g. ``device="cpu"``."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m cg_mrslam_tpu_torch {srslam|cg_mrslam} "
              "[flags]\n"
              "  srslam     single-robot SLAM on the synthetic world or a "
              "CARMEN log\n"
              "  cg_mrslam  multi-robot condensed-graph SLAM, all robots "
              "in this process or (--idRobot r) one per process over UDP")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "srslam":
        return cmd_srslam(rest, device)
    if cmd == "cg_mrslam":
        return cmd_cg_mrslam(rest, device)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
