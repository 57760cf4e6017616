"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (nothing is caught; any failure ends the run with a traceback):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build the score-volume kernels K1 and K2, K2's fused ``known_cap`` pair
   and the two timing probes (``csrc/score_volume.cu``, one nvcc); print
   its ``ptxas -v`` report and the card's maximum SM clock;
3. ``srslam``: the single-robot default deployment (40 x 20 m hospital
   world, seed 0, 2 loops, 360 beams, 10 m range, capacity 512/2048, close
   grid 30 m at 0.025 m, LC grid 70 m at 0.1 m) through ``SingleRobotSlam``
   on the card, up to capacity - 2 keyframes, with K1's launch counts set
   to 0 just before and read just after; checks launches = 3 per keyframe,
   finite chi2, at least one accepted closure, ATE below the odometry-only
   ATE, every keyframe on the dense Cholesky band; prints ATE, the solver
   backend per keyframe and keyframe latency p50/p99 per bucket;
4. K1 at its three main-path shapes (close, near, loop), on the inputs of
   the first call of each shape in phase 3 whose volume depends on where
   the points land (a grid that is not constant under kept points, and a
   score that varies along both offset axes): against its plain PyTorch
   version (rtol 1e-5, atol 1e-6), timed as ``ms`` (CUDA events over
   back-to-back wrapper calls), ``device_ms`` (the calls captured into a
   CUDA graph and replayed: device time only) and ``host_us`` (the host's
   enqueue per call), beside the bytes bound; then the two timing probes
   (``no_gather``, ``const_cells``: wrong by design, each held to its own
   plain version) on the same inputs, timed the same way. The log line of
   each also gives the issue floor at the card's maximum SM clock (computed,
   so not in the JSON record);
5. the first 20 ``srslam`` keyframes replayed on the CPU (plain versions),
   poses against the card's;
6. ``cg_mrslam``: the in-process multi-robot default deployment (2 robots,
   the same world and sensors, robot r on seed 7r, comm range 5 m,
   ``MRConfig`` defaults) through ``MultiRobotSim`` on the card until both
   robots stop keyframing at capacity - 4, with K1's and K2's counts set to
   0 just before and read just after; checks foreign vertices on every
   robot, at least one accepted inter-robot closure and one spliced star,
   finite chi2, K2 launches = 4 per robot per exchange round (every one the
   fused pair), no probe launched, K1 launches = 3 per keyframe, keyframes on the dense Cholesky band and condense on the
   chain or PCG band, per-robot ATE below the odometry-only ATE and a
   median cross-robot pose agreement under 0.6 m (``tests/test_mrslam.py``'s
   bar); prints those, condenses by band, keyframe and exchange-round time
   p50/p99 (host clock, the card synchronized around each) and the split of
   a round (CUDA events, no synchronization added);
7. K2's pair at the level-0 and refine lattices of phase 6, on live
   captured inputs, against its plain version (rtol 1e-5, atol 1e-6), timed
   and probed as in phase 4;
8. phase 6 replayed on the CPU (plain versions) up to the first exchange
   round in which a robot accepts an inter-robot closure (so combos were
   received, parked vertices matched by the global search into buffered
   hypotheses, and those voted in): every round's outcomes — vertices,
   foreign and parked vertices, buffered hypotheses, inter-robot closures,
   star edges — equal to the card's, own keyframe poses within 1e-3 m /
   rad;
9. the command line (``python -m cg_mrslam_tpu_torch``, each command a
   subprocess in ``chiprun_out/cli/``, on the card; each must exit 0):
   (a) ``srslam`` at the default deployment: as many keyframe lines as
   phase 3 had keyframes, closures within ±1; its ``.g2o`` loads through
   both parsers alike (ids, edges, poses within 1e-6); the loaded graph's
   chi2 equals the last printed chi2 (1e-3 relative, or the print's
   rounding); its ATE within 0.02 m
   of phase 3's; its map's sides a multiple of 128 and its occupied share
   in (0.001, 0.2), the share of its occupied cells within 0.1 m of a wall
   printed; the same scans integrated at the ground-truth keyframe poses
   hold ``tests/test_occupancy.py``'s bar (≥ 90% of the occupied cells
   within 0.1 m of a wall, occupied share in (0.001, 0.2)); the metrics JSONL
   written; the largest pose difference against phase 3 printed. Then
   ``integrate`` (ms, peak memory), ``g2o.save`` and ``load`` (native and
   Python) timed on that graph. (b) ``srslam --ticks 800``, then
   ``SingleRobotSlam.resume`` of its ``.g2o`` in this process fed the rest
   of the route (as ``tests/test_resume.py`` does): the reloaded vertices
   and poses, finite chi2, ATE below the odometry-only ATE. (c) ``srslam
   --carmen`` on the route's first 400 ticks written with the port's
   ``carmen.write``: keyframes and a ``.g2o``. (d) ``cg_mrslam --nRobots 2
   --ticks 300``: two ``.g2o`` files and two maps, an accepted inter-robot
   closure, each graph holding the peer's namespaced keyframes.

The card's line comes again just before the ``kernels`` JSON record (every
kernel and probe record), which is the line before last; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available.
"""

from __future__ import annotations

import collections
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 1e-5, 1e-6
N_CPU_KEYFRAMES = 20
# the CPU replay of phase 8 stops at the first inter-robot closure; it
# fails if that comes later than this many exchange rounds
MAX_CPU_ROUNDS = 60
# tests/test_mrslam.py's bar on the median cross-robot disagreement
MAX_AGREEMENT_M = 0.6
# a volume that varies by less than this along an offset axis cannot tell a
# kernel that reads the right cells from one that does not
MIN_SPREAD = 100 * ATOL
SHAPES = {"close": (65, 12, 12), "near": (17, 3, 3), "loop": (65, 15, 5)}
# K2's lattices on the multi-robot path, by stride: level 0 of the
# hierarchical search at step 8, the refine levels at steps 4, 2, 1
STRIDED = {"level0": 8, "refine4": 4, "refine2": 2, "refine1": 1}
REPLACES = "cg_mrslam_tpu/ops/correlate.py:189 (_make_kernel_v3 via " \
           "pallas_score_volume, :477; pallas_call at :454)"
REPLACES_K2 = "cg_mrslam_tpu/ops/correlate.py:505 (pallas_score_volume_" \
              "strided; body _make_kernel_v3 :189, pallas_call at :454)"
# the timing probes: the TPU probe each stands for
REPLACES_PROBE = {
    "no_gather": "cg_mrslam_tpu/ops/correlate.py:226 (_make_kernel_x1, "
                 "timing probe; pallas_call at :454)",
    "const_cells": "cg_mrslam_tpu/ops/correlate.py:257 (_make_kernel_x2, "
                   "timing probe; pallas_call at :454)"}
SOURCE = "cg_mrslam_tpu_torch/csrc/score_volume.cu"
ROOT = Path(__file__).resolve().parent
CLI_DIR = ROOT / "chiprun_out" / "cli"
# the resumed run of phase 9: saved at this tick, resumed in this process
RESUME_TICK = 800


def log(*a):
    print(*a, flush=True)


def plain_of(args, ty, tx):
    """The plain version of a K1 or K2 call on its wrapper's arguments."""
    from cg_mrslam_tpu_torch.ops import correlate as K

    if len(args) == 11 and args[10] is not None:
        return K.volume_pair_plain(*args[:6], ty, tx, args[10])
    return K.volume_plain(*args[:6], ty, tx)


def k1_name(args) -> str:
    """K1's call ``(grids, gidx, ix, iy, keep, count, ry, rx)`` by shape."""
    key = (args[2].shape[1], args[6], args[7])
    return next(k for k, v in SHAPES.items() if v == key)


def k2_name(args) -> str:
    """K2's call ``(..., ny, nx, sy, sx)`` by stride."""
    return next(k for k, v in STRIDED.items() if v == args[8])


def live_volumes(grids, gidx, keep) -> torch.Tensor:
    """``[B]``: volume ``b`` keeps points and its grid is not constant."""
    flat = grids.flatten(1)
    varied = (flat.amax(1) > flat.amin(1))[gidx.long()]
    return varied & keep.flatten(1).any(1)


def spreads(vol, live):
    """Largest spread of the live volumes of ``vol [B,T,Dy,Dx]`` (or a
    pair's ``[B,2,T,Dy,Dx]``) along Dy and along Dx (0 when no volume is
    live)."""
    if not bool(live.any()):
        return 0.0, 0.0
    v = vol[live].flatten(1, -3)
    return (float((v.amax(2) - v.amin(2)).max()),
            float((v.amax(3) - v.amin(3)).max()))


class Capture:
    """Stands in for the kernel wrapper inside ``matcher.search``. It
    launches through the real wrapper, so the launch counts are the
    wrapper's own, and keeps a copy of the inputs of the first call of each
    shape whose volume depends on where the points land — on inputs where
    every score is the same constant, a kernel that ignored its offsets or
    misread its grid index would still agree with the plain version."""

    def __init__(self, kernel, name_of, names):
        self.kernel = kernel
        self.name_of = name_of
        self.names = names
        self.calls = {}      # shape name -> kernel inputs
        self.pending = {}    # shape name -> (kernel inputs, output)
        self.keyframe = {}   # shape name -> keyframe it was captured at

    @property
    def armed(self) -> bool:
        return len(self.calls) < len(self.names)

    def __call__(self, *args):
        out = self.kernel(*args)
        name = self.name_of(args)
        if self.armed and name not in self.calls:
            self.pending[name] = (tuple(a.clone() if torch.is_tensor(a)
                                        else a for a in args), out.clone())
        return out

    def settle(self, keyframe: int) -> None:
        """After a keyframe or an exchange round (outside its clock): keep
        the pending calls that are live."""
        for name, (args, out) in self.pending.items():
            live = live_volumes(args[0], args[1], args[4])
            if min(spreads(out, live)) >= MIN_SPREAD:
                self.calls[name] = args
                self.keyframe[name] = keyframe
        self.pending.clear()


def deployment_config(n_robots: int):
    """The CLI defaults of ``srslam`` (1 robot) and ``cg_mrslam`` (2)."""
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)

    return Config(
        slam=SlamConfig(linear_update=0.25, angular_update=math.pi / 4,
                        min_inliers=7, window_loop_closure=10,
                        inlier_threshold=2.0),
        mr=MRConfig(n_robots=n_robots, max_score_mr=0.15, min_inliers_mr=5,
                    window_mr_loop_closure=10, sim_comm_range=5.0),
        close_matcher=MatcherConfig(extent=30.0, resolution=0.025,
                                    kernel_radius=0.2, max_score=0.15),
        lc_matcher=MatcherConfig(extent=70.0, resolution=0.1,
                                 kernel_radius=0.5, max_score=0.15),
        max_vertices=512, max_edges=2048)


def srslam_setup():
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = deployment_config(1)
    world = W.hospital_world(40.0, 20.0, seed=0)
    wps = W.corridor_waypoints(40.0, 20.0, 0, 2)
    fov = 2 * np.pi * 0.75
    traj = W.simulate_robot(world, wps, seed=1, beams=360, fov=fov,
                            max_range=10.0, odom_noise=(0.01, 0.004),
                            device="cuda")
    return cfg, traj, fov


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS translational error after SE(2) alignment of the first pose."""
    def compose(a, b):
        c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                         a[..., 1] + s * b[..., 0] + c * b[..., 1],
                         a[..., 2] + b[..., 2]], -1)

    e0 = est[0].astype(np.float64)
    c, s = np.cos(e0[2]), np.sin(e0[2])
    inv = np.array([-(c * e0[0] + s * e0[1]), -(-s * e0[0] + c * e0[1]),
                    -e0[2]])
    aligned = compose(compose(gt[0], inv), est.astype(np.float64))
    return float(np.sqrt(np.mean(np.sum(
        (aligned[:, :2] - gt[:, :2]) ** 2, axis=1))))


def run_slice(cfg, traj, fov, device, max_keyframes=None, capture=None):
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

    slam = SingleRobotSlam(cfg, traj.ranges.shape[1], traj.gt[0],
                           traj.ranges[0], fov=fov, max_range=10.0,
                           device=device)
    cuda = slam.device.type == "cuda"
    kf_t, lat = [0], {}
    for t in range(1, len(traj.gt)):
        bucket = slam.runner.bucket(slam.state)[0]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if slam.observe(traj.rel_odom[t - 1], traj.ranges[t]):
            if cuda:
                torch.cuda.synchronize()
            lat.setdefault(bucket, []).append(time.perf_counter() - t0)
            kf_t.append(t)
            if capture is not None and capture.armed:
                capture.settle(len(slam.infos))
            if max_keyframes and len(slam.infos) >= max_keyframes:
                break
        if int(slam.state.graph.n_vertices) >= cfg.max_vertices - 2:
            break
    return slam, np.asarray(kf_t), lat


def lattice_args(args):
    """``(ny, nx, sy, sx)`` of a K1 or K2 call."""
    return (args[6], args[7], 1, 1) if len(args) == 8 else args[6:10]


def check_kernel(kernel, args, ty, tx):
    """Kernel vs plain on one captured call over the lattice ``ty x tx``,
    then its times: ``ms`` (CUDA events over back-to-back wrapper calls),
    ``device_ms`` (CUDA graph replay: device time only, two runs) and
    ``host_us`` (the host's enqueue per wrapper call). Returns the
    record."""
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    grids, gidx, ix, iy, keep, count = args[:6]
    got = kernel(*args)
    want = plain_of(args, ty, tx)
    torch.cuda.synchronize()
    # the inputs must make the comparison able to fail: some volume with
    # kept points on a grid that is not constant, whose plain scores vary
    # along both offset axes
    live = live_volumes(grids, gidx, keep)
    spread_y, spread_x = spreads(want, live)
    assert min(spread_y, spread_x) >= MIN_SPREAD, (spread_y, spread_x)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    ms = CT.event_ms(lambda: kernel(*args))
    plain_ms = CT.event_ms(lambda: plain_of(args, ty, tx), reps=5)
    dev_ms = [CT.graph_ms(lambda: kernel(*args)) for _ in range(2)]
    b, t, p = ix.shape
    n_off = ty.numel() * tx.numel()
    n_grids = int(torch.unique(gidx).numel())
    bound_ms, bound_by = CT.volume_bound(n_grids * grids[0].numel() * 4, b,
                                         t, p, n_off, want.numel(),
                                         int(keep.sum()))
    return {"shape": list(want.shape), "points": p,
            "grid_cells": grids.shape[-1], "grids": n_grids,
            "live_volumes": int(live.sum()),
            "spread_dy": spread_y, "spread_dx": spread_x,
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "device_ms": float(np.mean(dev_ms)), "device_ms_runs": dev_ms,
            "host_us": CT.host_us(lambda: kernel(*args)),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_probes(args, ty, tx, where: str) -> list:
    """Both timing probes on one captured call: each against its own
    plain version (:func:`correlate.probe_plain`; a probe is not a score
    volume), timed like the kernel. Records named ``probe_<mode>[where]``;
    ``launches`` is filled in from the main path's counts."""
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    grids, gidx, ix, iy, keep, count = args[:6]
    window = lattice_args(args)
    b, t, p = ix.shape
    n_off = ty.numel() * tx.numel()
    out = []
    for probe in (K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS):
        call = (lambda probe=probe: probe(*args[:6], *window))
        got = call()
        want = K.probe_plain(probe.mode, *args[:6], ty, tx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # what the probe must move: no grid for no_gather, the Dy x Dx
        # cells around the one staged cell for const_cells
        grid_bytes = 0 if probe.mode == "no_gather" else n_off * 4
        bound_ms, bound_by = CT.volume_bound(grid_bytes, b, t, p, n_off,
                                             want.numel(), b * t * p)
        out.append({
            "name": f"probe_{probe.mode}[{where}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES_PROBE[probe.mode],
            "probe": True, "launches": None, "shape": list(want.shape),
            "points": p,
            "max_abs_err": float((got - want).abs().max()),
            "ms": CT.event_ms(call), "device_ms": CT.graph_ms(call),
            "host_us": CT.host_us(call),
            "plain_ms": CT.event_ms(lambda probe=probe: K.probe_plain(
                probe.mode, *args[:6], ty, tx), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return out


def kernel_line(rec, ghz: float) -> str:
    """A record for the log, with the issue floor at ``ghz`` (T·Dy·Dx·P
    loads per volume, computed from the record's shape)."""
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    loads = math.prod(rec["shape"]) // (2 if rec.get("pair") else 1)
    floor = CT.issue_floor_ms(loads * rec["points"], ghz)
    return (f"kernel {rec['name']} {rec['shape']}: ms {rec['ms']:.4f}, "
            f"device_ms {rec['device_ms']:.5f}, host_us "
            f"{rec['host_us']:.1f}, issue floor {floor:.5f} ms at "
            f"{ghz:.3f} GHz (computed), bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']}, plain {rec['plain_ms']:.3f} ms, "
            f"max_abs_err {rec['max_abs_err']:.3g}")


def lattice(n: int, s: int, dev) -> torch.Tensor:
    return torch.arange(-n, n + 1, dtype=torch.int32, device=dev) * s


def percentiles(ms) -> str:
    v = np.asarray(ms)
    return (f"p50 {np.percentile(v, 50):.2f} ms, p99 "
            f"{np.percentile(v, 99):.2f} ms, max {v.max():.2f} ms "
            f"(n={len(v)})")


def outcomes(st) -> dict:
    """A robot's multi-robot outcomes, read on the host."""
    g = st.slam.graph
    vm = g.vmask.cpu().numpy()
    vo = st.slam.v_owner.cpu().numpy()
    em = g.emask.cpu().numpy()
    ij = g.e_ij.cpu().numpy()[em]
    lvl = g.e_level.cpu().numpy()[em]
    me = int(st.slam.my_id)
    return {"vertices": int(g.n_vertices),
            "foreign": int(((vo != me) & vm).sum()),
            "parked": int(st.parked.sum()),
            "hypotheses": int(st.peer_buf.mask.sum()),
            "inter_closures": int(((vo[ij[:, 0]] != vo[ij[:, 1]])
                                   & (lvl == 0)).sum()),
            "star_edges": int((lvl > 0).sum())}


def own_poses(st) -> np.ndarray:
    """A robot's own keyframe poses in keyframe order."""
    vm = st.slam.graph.vmask.cpu().numpy()
    vo = st.slam.v_owner.cpu().numpy()
    vr = st.slam.v_remote.cpu().numpy()
    own = np.flatnonzero(vm & (vo == int(st.slam.my_id)))
    return st.slam.graph.poses.cpu().numpy()[own[np.argsort(vr[own])]]


def cross_err(host, guest) -> np.ndarray:
    """Per foreign vertex of ``guest`` that ``host`` constrains (an edge
    touches it): the distance between the host's estimate and the
    owner's own (``tests/test_mrslam.py``'s cross-consistency check)."""
    g = host.slam.graph
    vm = g.vmask.cpu().numpy()
    vo = host.slam.v_owner.cpu().numpy()
    vr = host.slam.v_remote.cpu().numpy()
    em = g.emask.cpu().numpy()
    ij = g.e_ij.cpu().numpy()[em]
    deg = np.bincount(ij.reshape(-1), minlength=len(vm))
    gid = int(guest.slam.my_id)
    gvr = guest.slam.v_remote.cpu().numpy()
    gvo = guest.slam.v_owner.cpu().numpy()
    gvm = guest.slam.graph.vmask.cpu().numpy()
    gp = guest.slam.graph.poses.cpu().numpy()
    hp = g.poses.cpu().numpy()
    errs = []
    for slot in np.flatnonzero(vm & (vo == gid) & (deg > 0)):
        m = gvm & (gvo == gid) & (gvr == vr[slot])
        if m.any():
            errs.append(np.hypot(*(hp[slot, :2] - gp[np.argmax(m), :2])))
    return np.asarray(errs)


class Timed:
    """Wraps ``fn`` to record its time in ms. With ``sync`` the card is
    synchronized before and after the call and the host clock read (the
    end-to-end steps: a keyframe, an exchange round); otherwise, on the
    card, CUDA events are recorded around it on the current stream and
    read after the run (``ms``), so the call adds no synchronization (the
    steps inside a round)."""

    def __init__(self, fn, sync: bool, cuda: bool):
        self.fn, self.sync, self.cuda = fn, sync, cuda
        self.records = []    # ms, or a (start, end) pair of CUDA events

    def __call__(self, *a, **k):
        if self.cuda and not self.sync:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **k)
            e1.record()
            self.records.append((e0, e1))
            return out
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        if self.sync:
            torch.cuda.synchronize()
        self.records.append((time.perf_counter() - t0) * 1e3)
        return out

    @property
    def ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
        return [r if isinstance(r, float) else r[0].elapsed_time(r[1])
                for r in self.records]


class TimedBand:
    """Wraps a banded solver entry point of ``solver.gauss_newton`` to
    record the time in ms (CUDA events on the card) of each call that
    condense makes (``chol`` off) under the band it took, read from
    ``BAND_CALLS``; ``chol`` calls (the keyframe's) pass through
    untimed."""

    def __init__(self, gn, name: str, cuda: bool):
        self.gn, self.name = gn, name
        self.fn = getattr(gn, name)
        self.timed = Timed(self.fn, False, cuda)
        self.bands = []

    def __call__(self, *a, **k):
        if k.get("chol", False):
            return self.fn(*a, **k)
        before = dict(self.gn.BAND_CALLS)
        out = self.timed(*a, **k)
        self.bands.append(next(
            b for (e, b), v in self.gn.BAND_CALLS.items()
            if e == self.name and v != before.get((e, b), 0)))
        return out

    @property
    def ms(self) -> dict:
        out = collections.defaultdict(list)
        for band, ms in zip(self.bands, self.timed.ms):
            out[band].append(ms)
        return out


def run_mr(device, max_ticks=None, capture=None):
    """The ``cg_mrslam`` deployment through ``MultiRobotSim`` on
    ``device``. Records, per exchange round, the tick and each robot's
    outcomes and own poses, and the keyframe ticks of each robot. Returns
    ``(sim, times, log)``: ``times`` maps each timed step to its times in
    ms."""
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim
    from cg_mrslam_tpu_torch.sim import world as W
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    cfg = deployment_config(2)
    world = W.hospital_world(40.0, 20.0, seed=0)
    sim = MultiRobotSim(cfg, world, beams=360, max_range=10.0, seed=0,
                        n_loops=2, odom_noise=(0.01, 0.004), width=40.0,
                        height=20.0, device=device)
    cuda = torch.device(device).type == "cuda"
    log = {"rounds": [], "kf_ticks": [[0] for _ in range(sim.R)]}
    keyframe, exchange = sim.keyframe, sim.exchange_round
    timers = {"keyframe": Timed(keyframe, cuda, cuda),
              "exchange_round": Timed(exchange, cuda, cuda),
              "try_match_parked": Timed(MR.try_match_parked, False, cuda),
              "build_star": Timed(MR.build_star, False, cuda)}
    bands = [TimedBand(gn, name, cuda)
             for name in ("optimize_auto", "marginal_covariance_auto")]

    def on_keyframe(r, t):
        log["kf_ticks"][r].append(t)
        return timers["keyframe"](r, t)

    def on_exchange(t, modality="sim"):
        timers["exchange_round"](t, modality)
        if capture is not None and capture.armed:
            capture.settle(len(log["rounds"]))
        log["rounds"].append((t, [outcomes(st) for st in sim.states],
                              [own_poses(st) for st in sim.states]))

    sim.keyframe, sim.exchange_round = on_keyframe, on_exchange
    MR.try_match_parked = timers["try_match_parked"]
    MR.build_star = timers["build_star"]
    for tb in bands:
        setattr(gn, tb.name, tb)
    try:
        sim.run(max_ticks=max_ticks)
    finally:
        MR.try_match_parked = timers["try_match_parked"].fn
        MR.build_star = timers["build_star"].fn
        for tb in bands:
            setattr(gn, tb.name, tb.fn)
    times = {name: t.ms for name, t in timers.items()}
    for tb in bands:
        for band, ms in tb.ms.items():
            times[f"condense {tb.name} [{band}]"] = ms
    return sim, times, log


def run_cli(*argv: str):
    """``python -m cg_mrslam_tpu_torch argv`` in ``chiprun_out/cli/`` on the
    card; fails unless it exits 0. Returns its stdout and wall seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cg_mrslam_tpu_torch",
                          *argv], cwd=CLI_DIR, env=env, capture_output=True,
                         text=True)
    wall = time.perf_counter() - t0
    name = argv[argv.index("-o") + 1]
    (CLI_DIR / f"{name}.log").write_text(res.stdout + res.stderr)
    assert res.returncode == 0, (argv, res.returncode, res.stderr[-3000:])
    log(f"cli: {' '.join(argv)}: exit 0 in {wall:.1f} s")
    return res.stdout, wall


def keyframe_lines(stdout: str) -> list:
    """``(closures, chi2)`` of each ``keyframe`` line of an ``srslam`` run."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("keyframe "):
            f = dict(t.split("=", 1) for t in line.split()[2:])
            out.append((int(f["closures"].lstrip("+")), float(f["chi2"])))
    return out


def wall_distance(pts: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Distance from each point ``[P,2]`` to the nearest segment ``[S,4]``."""
    a, b = segs[None, :, :2], segs[None, :, 2:]
    ab = b - a
    t = np.clip(np.sum((pts[:, None] - a) * ab, -1)
                / np.maximum(np.sum(ab * ab, -1), 1e-12), 0.0, 1.0)
    near = a + t[..., None] * ab
    return np.min(np.linalg.norm(pts[:, None] - near, axis=-1), axis=1)


def read_map(base: Path):
    """A ``.pgm/.yaml`` map: the image (row 0 at the top), its origin and
    resolution."""
    head, img = (base.with_suffix(".pgm")).read_bytes().split(b"255\n", 1)
    w, h = map(int, head.split()[1:3])
    meta = dict(line.split(": ", 1) for line in
                base.with_suffix(".yaml").read_text().splitlines())
    origin = [float(v) for v in meta["origin"].strip("[]").split(",")[:2]]
    return (np.frombuffer(img, np.uint8).reshape(h, w), np.asarray(origin),
            float(meta["resolution"]))


def phase_cli(cfg, traj, fov, slam, kf_t) -> None:
    """Phase 9: the command line (see the module docstring)."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.io import carmen, g2o
    from cg_mrslam_tpu_torch.maps import occupancy as OCC
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam
    from cg_mrslam_tpu_torch.sim import world as W

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    walls = W.hospital_world(40.0, 20.0, seed=0).segments

    # (a) the srslam default deployment
    out, _ = run_cli("srslam", "-o", "smoke")
    kfl = keyframe_lines(out)
    n_kf = len(slam.infos)
    closures = sum(i.closures_added for i in slam.infos)
    assert len(kfl) == n_kf, (len(kfl), n_kf)
    assert abs(sum(c for c, _ in kfl) - closures) <= 1, (kfl, closures)
    path = str(CLI_DIR / "robot-0-smoke.g2o")
    nat = g2o.load(path, native=True)
    py = g2o.load(path, native=False)
    np.testing.assert_array_equal(nat.ids, py.ids)
    for name in ("e_ij", "emask", "e_owner", "e_level", "vmask", "fixed"):
        assert torch.equal(getattr(nat.graph, name),
                           getattr(py.graph, name)), name
    assert float((nat.graph.poses - py.graph.poses).abs().max()) <= 1e-6
    c2 = float(chi2(nat.graph))
    # 1e-3 relative, or the rounding of the printed 2 decimals
    assert abs(c2 - kfl[-1][1]) <= max(1e-3 * abs(kfl[-1][1]), 0.005), \
        (c2, kfl[-1])
    poses = nat.graph.poses.cpu().numpy()[:n_kf + 1]
    gt = traj.gt[kf_t]
    a_cli, a_p3 = ate(poses, gt), ate(slam.poses, gt)
    assert abs(a_cli - a_p3) <= 0.02, (a_cli, a_p3)
    # the file holds 6 decimals: phase 3's poses written the same way
    p3 = np.asarray([[float(f"{v:.6f}") for v in p] for p in slam.poses],
                    np.float32)
    log(f"cli: srslam: {len(kfl)} keyframes, closures "
        f"{sum(c for c, _ in kfl)} (phase 3: {closures}), loaded chi2 "
        f"{c2:.4f} (printed {kfl[-1][1]:.2f}), ATE {a_cli:.4f} m (phase 3: "
        f"{a_p3:.4f} m); largest pose difference against phase 3 "
        f"{np.abs(poses - slam.poses).max():.3g} (against phase 3 written "
        f"to 6 decimals: {np.abs(poses - p3).max():.3g})")
    img, origin, res = read_map(CLI_DIR / "robot-0-smoke-map")
    assert img.shape[0] % 128 == 0 and img.shape[1] % 128 == 0, img.shape
    rows, cols = np.nonzero(img[::-1] == 0)          # OCCUPIED, y up
    centers = origin + (np.stack([cols, rows], 1) + 0.5) * res
    dist = wall_distance(centers, walls)
    share = float((img == 0).mean())
    log(f"cli: srslam map {img.shape} (the run's poses): {len(rows)} "
        f"occupied cells, {float((dist <= 0.1).mean()):.4f} of them within "
        f"0.1 m of a wall (distance p50 {np.median(dist):.3f} m, p90 "
        f"{np.percentile(dist, 90):.3f} m), occupied share {share:.5f}")
    assert 0.001 < share < 0.2, share
    # the same scans at the ground-truth keyframe poses: the map module
    # held to tests/test_occupancy.py's bar (the run's own map is off by
    # its pose error, ATE above)
    g = nat.graph
    gt_poses = g.poses.clone()
    gt_poses[:n_kf + 1] = torch.as_tensor(gt, dtype=torch.float32,
                                          device="cuda")
    pn = gt[:, :2]
    center = OCC.map_center(gt, pad=10.0)
    cells = int(np.ceil(((pn.max(0) - pn.min(0)).max() + 20.0)
                        / cfg.map.resolution / 128.0)) * 128
    mc = cfg.map

    def integrate(poses):
        return OCC.integrate(
            poses, nat.scans, torch.as_tensor(center, device="cuda"),
            cells=cells, resolution=mc.resolution, max_range=10.0,
            usable_range=mc.usable_range, gain=mc.gain,
            square_size=mc.square_size,
            infinity_filling_range=mc.infinity_filling_range, angle=0.0,
            robot_fill=mc.robot_fill)

    tri = OCC.threshold(integrate(gt_poses)).cpu().numpy()
    rows, cols = np.nonzero(tri == OCC.OCCUPIED)     # row 0 at y min
    origin = center - mc.resolution * cells / 2.0
    near = float((wall_distance(origin + (np.stack([cols, rows], 1) + 0.5)
                                * mc.resolution, walls) <= 0.1).mean())
    share = float((tri == OCC.OCCUPIED).mean())
    log(f"cli: the same scans at the ground-truth poses: {len(rows)} "
        f"occupied cells, {near:.4f} within 0.1 m of a wall, occupied "
        f"share {share:.5f}")
    assert near >= 0.9 and 0.001 < share < 0.2, (near, share)
    metrics = CLI_DIR / "robot-0-smoke-metrics.jsonl"
    assert metrics.stat().st_size > 0

    # the outputs' own costs on this graph (455 vertices)
    vm = g.vmask.cpu().numpy()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        integrate(g.poses)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_samples = int(vm.sum()) * nat.scans.ranges.shape[1] * int(
        math.ceil(10.0 / (mc.resolution / math.sqrt(2.0))) + 1)
    io_ms = {}
    for name, fn in (("save", lambda: g2o.save(str(CLI_DIR / "t.g2o"), g,
                                               ids=nat.ids,
                                               scans=nat.scans)),
                     ("load native", lambda: g2o.load(path, native=True)),
                     ("load python", lambda: g2o.load(path, native=False))):
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        io_ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    log(f"cli: integrate {cells}^2 cells, {n_samples} samples: "
        f"{np.median(ms):.2f} ms (median of 5), peak "
        f"{peak:.3f} GiB above the inputs; at {int(vm.sum())} vertices "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in io_ms.items()))

    # (b) resume: half the route through the command line, the rest here
    out, _ = run_cli("srslam", "--ticks", str(RESUME_TICK), "-o", "half")
    n_half = len(keyframe_lines(out))
    assert n_half == int((kf_t[1:] < RESUME_TICK).sum()), n_half
    half = str(CLI_DIR / "robot-0-half.g2o")
    res = SingleRobotSlam.resume(cfg, half)
    assert int(res.state.graph.n_vertices) == n_half + 1
    saved = g2o.load(half, max_vertices=cfg.max_vertices,
                     max_edges=cfg.max_edges)
    assert torch.equal(res.state.graph.poses, saved.graph.poses)
    assert int(res.state.scans.smask.sum()) == n_half + 1
    ticks = list(kf_t[:n_half + 1])
    for t in range(RESUME_TICK, len(traj.gt)):
        if res.observe(traj.rel_odom[t - 1], traj.ranges[t]):
            ticks.append(t)
        if res.runner.n_live >= cfg.max_vertices - 2:
            break
    assert all(np.isfinite(i.chi2) for i in res.infos) and res.infos
    a_res = ate(res.poses, traj.gt[ticks])
    a_odo = ate(traj.odom[ticks], traj.gt[ticks])
    log(f"cli: resume: {n_half + 1} vertices reloaded, {len(res.infos)} "
        f"keyframes after; final chi2 {res.infos[-1].chi2:.4f}, ATE "
        f"{a_res:.4f} m vs odometry ATE {a_odo:.4f} m")
    assert a_res < a_odo, (a_res, a_odo)

    # (c) a CARMEN log of the route's first 400 ticks
    beams = traj.ranges.shape[1]
    clf = CLI_DIR / "route.clf"
    carmen.write(str(clf), traj.odom[:400], traj.ranges[:400], fov=fov,
                 max_range=10.0, start_angle=-fov / 2,
                 angular_step=fov / beams)
    out, _ = run_cli("srslam", "--carmen", str(clf), "-o", "carmen")
    n_c = len(keyframe_lines(out))
    assert n_c > 0 and (CLI_DIR / "robot-0-carmen.g2o").exists(), n_c
    log(f"cli: carmen: {n_c} keyframes")

    # (d) two robots in one process
    out, _ = run_cli("cg_mrslam", "--nRobots", "2", "--modality", "sim",
                     "--ticks", "300", "-o", "mr")
    accepted = [int(line.rsplit("=", 1)[1]) for line in out.splitlines()
                if line.startswith("robot ") and "accepted=" in line]
    assert len(accepted) == 2 and sum(accepted) >= 1, out[-2000:]
    for r in range(2):
        for ext in (".g2o", "-map.pgm", "-map.yaml"):
            assert (CLI_DIR / f"robot-{r}-mr{ext}").exists(), (r, ext)
        ids = g2o.load(str(CLI_DIR / f"robot-{r}-mr.g2o")).ids
        ids = ids[ids >= 0]
        assert ((ids // cfg.slam.base_id) == 1 - r).any(), r
    log(f"cli: cg_mrslam: inter-robot closures accepted {accepted}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import cg_mrslam_tpu_torch.matcher.search as search
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    # --- 1. the card ---
    card = CT.card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    # --- 2. build ---
    t0 = time.perf_counter()
    K.load_library()
    log(f"build: score_volume.cu (K1, K2, the pair, the probes) in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"ptxas -v:\n{K.ptxas_report()}")
    ghz = CT.max_sm_clock_ghz()
    log(f"max SM clock {ghz:.3f} GHz (the issue floor's clock)")
    probes = (K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS)

    # --- 3. the slice on the card ---
    t0 = time.perf_counter()
    cfg, traj, fov = srslam_setup()
    log(f"sim: {len(traj.gt)} ticks, {traj.ranges.shape[1]} beams in "
        f"{time.perf_counter() - t0:.2f} s")
    capture = Capture(K.SCORE_VOLUME, k1_name, SHAPES)
    search.SCORE_VOLUME = capture
    for k in (K.SCORE_VOLUME,) + probes:
        k.launches = 0
        k.launches_by_shape.clear()
    t0 = time.perf_counter()
    slam, kf_t, lat = run_slice(cfg, traj, fov, "cuda", capture=capture)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.SCORE_VOLUME.launches
    by_shape = dict(K.SCORE_VOLUME.launches_by_shape)
    assert all(k.launches == 0 for k in probes), "a probe ran on the path"
    search.SCORE_VOLUME = K.SCORE_VOLUME
    n_kf = len(slam.infos)
    infos = slam.infos
    closures = sum(i.closures_added for i in infos)
    gt = traj.gt[kf_t]
    ate_slam = ate(slam.poses, gt)
    ate_odom = ate(traj.odom[kf_t], gt)
    log(f"slice: {n_kf} keyframes ({slam.poses.shape[0]} vertices of "
        f"{cfg.max_vertices}) in {wall:.2f} s; score_volume launches "
        f"{launches} ({by_shape}); closures {closures}; "
        f"sm_accepted {sum(bool(i.sm_accepted) for i in infos)}; "
        f"final chi2 {infos[-1].chi2:.4f}")
    log(f"slice: ATE {ate_slam:.4f} m vs odometry ATE {ate_odom:.4f} m")
    backends = collections.Counter(i.solver_backend for i in infos)
    log(f"slice: solver backend per keyframe {dict(backends)} (0 dense "
        f"Cholesky, 1 chain, 2 PCG)")
    for b in sorted(lat):
        v = np.asarray(lat[b]) * 1e3
        log(f"slice: bucket {b}: {len(v)} keyframes, latency p50 "
            f"{np.percentile(v, 50):.2f} ms, p99 {np.percentile(v, 99):.2f} "
            f"ms, max {v.max():.2f} ms")
    assert n_kf >= 300, n_kf
    assert set(backends) == {0}, backends
    assert 512 in lat and 256 in lat, sorted(lat)
    assert launches == 3 * n_kf, (launches, n_kf)
    assert all(np.isfinite(i.chi2) for i in infos)
    assert closures >= 1, closures
    assert ate_slam < ate_odom, (ate_slam, ate_odom)

    # --- 4. the kernel at the main-path shapes ---
    assert sorted(capture.calls) == sorted(SHAPES), sorted(capture.calls)
    records, probe_records = [], []
    for name in SHAPES:
        args = capture.calls[name]
        dev = args[0].device
        ty, tx = lattice(args[6], 1, dev), lattice(args[7], 1, dev)
        rec = check_kernel(K.SCORE_VOLUME, args, ty, tx)
        key = tuple(rec["shape"])
        rec = {"name": f"score_volume[{name}]", "route": "cuda",
               "source": SOURCE, "replaces": REPLACES,
               "launches": by_shape[key],
               "launches_per_keyframe": by_shape[key] / n_kf,
               "captured_at_keyframe": capture.keyframe[name], **rec}
        assert by_shape[key] == n_kf, (name, by_shape[key], n_kf)
        records.append(rec)
        log(kernel_line(rec, ghz) + f" (keyframe {rec['captured_at_keyframe']}, "
            f"{rec['live_volumes']} live volumes, spread "
            f"{rec['spread_dy']:.4g}/{rec['spread_dx']:.4g})")
        for pr in check_probes(args, ty, tx, name):
            probe_records.append(pr)
            log(kernel_line(pr, ghz))

    # --- 5. the first keyframes on the CPU ---
    t0 = time.perf_counter()
    torch.set_num_threads(8)
    cpu, cpu_kf_t, _ = run_slice(cfg, traj, fov, "cpu",
                                 max_keyframes=N_CPU_KEYFRAMES)
    np.testing.assert_array_equal(cpu_kf_t, kf_t[:len(cpu_kf_t)])
    for k, (a, b) in enumerate(zip(cpu.infos, infos)):
        assert a.sm_accepted == b.sm_accepted, k
        d = np.asarray(a.pose, np.float64) - np.asarray(b.pose, np.float64)
        d[2] = (d[2] + np.pi) % (2 * np.pi) - np.pi
        assert np.all(np.abs(d) <= 1e-3), (k, d)
    log(f"cpu replay: {len(cpu.infos)} keyframes agree with the card "
        f"(1e-3 m / 1e-3 rad) in {time.perf_counter() - t0:.2f} s")

    # --- 6. the multi-robot deployment on the card ---
    capture2 = Capture(K.SCORE_VOLUME_STRIDED, k2_name, STRIDED)
    search.SCORE_VOLUME_STRIDED = capture2
    for k in (K.SCORE_VOLUME, K.SCORE_VOLUME_STRIDED) + probes:
        k.launches = 0
        k.launches_by_shape.clear()
    gn.BAND_CALLS.clear()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    sim, times, mlog = run_mr("cuda", capture=capture2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_mr = K.SCORE_VOLUME.launches
    k2_launches = K.SCORE_VOLUME_STRIDED.launches
    k2_by = dict(K.SCORE_VOLUME_STRIDED.launches_by_shape)
    probe_launches = sum(k.launches for k in probes)
    bands = dict(gn.BAND_CALLS)
    search.SCORE_VOLUME_STRIDED = K.SCORE_VOLUME_STRIDED
    n_rounds = len(mlog["rounds"])
    n_kf = [len(i) for i in sim.infos]
    log(f"cg_mrslam: {sim.R} robots, {sum(n_kf)} keyframes {n_kf}, "
        f"{n_rounds} exchange rounds in {wall:.2f} s; K1 launches {k1_mr}, "
        f"K2 launches {k2_launches} ({k2_by})")
    log(f"cg_mrslam: solver bands {bands}")
    outs = [outcomes(st) for st in sim.states]
    n_ticks = min(len(t.gt) for t in sim.trajs)
    gap = np.hypot(*(sim.trajs[0].gt[:n_ticks, :2]
                     - sim.trajs[1].gt[:n_ticks, :2]).T)
    log(f"cg_mrslam: robots within the {sim.cfg.mr.sim_comm_range} m comm "
        f"range on {int((gap < sim.cfg.mr.sim_comm_range).sum())} of "
        f"{n_ticks} ticks")
    for r, st in enumerate(sim.states):
        kt = np.asarray(mlog["kf_ticks"][r])
        tr = sim.trajs[r]
        est = own_poses(st)
        assert len(est) == len(kt), (len(est), len(kt))
        a_slam, a_odom = ate(est, tr.gt[kt]), ate(tr.odom[kt], tr.gt[kt])
        e = cross_err(st, sim.states[1 - r])
        log(f"cg_mrslam: robot {r}: {outs[r]}; closures "
            f"{int(sim.closure_stats[r])}; final chi2 "
            f"{sim.infos[r][-1].chi2:.4f}; ATE {a_slam:.4f} m vs odometry "
            f"ATE {a_odom:.4f} m; cross-robot agreement on {len(e)} "
            f"vertices: median {np.median(e) if len(e) else float('nan'):.4f}"
            f" m, max {e.max() if len(e) else float('nan'):.4f} m")
        assert outs[r]["foreign"] > 0, outs
        assert all(np.isfinite(i.chi2) for i in sim.infos[r])
        assert {i.solver_backend for i in sim.infos[r]} == {0}
        assert a_slam < a_odom, (r, a_slam, a_odom)
        assert len(e) > 0 and np.median(e) < MAX_AGREEMENT_M, (r, e)
    for name, ms in times.items():
        clock = ("host clock, synchronized" if name in ("keyframe",
                 "exchange_round") else "CUDA events")
        log(f"cg_mrslam: {name} ({clock}): {percentiles(ms)}, total "
            f"{sum(ms) / 1e3:.2f} s")
    log(f"cg_mrslam: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    condenses = {b: bands.get(("optimize_auto", b), 0)
                 for b in ("chain", "pcg")}
    log(f"cg_mrslam: condenses by band {condenses}")
    assert sum(o["inter_closures"] for o in outs) >= 1, outs
    assert sum(o["star_edges"] for o in outs) >= 1, outs
    assert k2_launches == 4 * sim.R * n_rounds, (k2_launches, n_rounds)
    # every level of the known-cap search is one fused-pair launch
    assert all(k[1] == 2 and len(k) == 7 for k in k2_by), k2_by
    assert probe_launches == 0, "a probe ran on the path"
    assert k1_mr == 3 * sum(n_kf), (k1_mr, n_kf)
    assert sum(condenses.values()) == len(times["build_star"]) > 0
    assert bands.get(("optimize_auto", "dense"), 0) == 2 * sum(n_kf)

    # --- 7. K2 at the path's lattices ---
    assert sorted(capture2.calls) == sorted(STRIDED), sorted(capture2.calls)
    for name, stride in STRIDED.items():
        args = capture2.calls[name]
        dev = args[0].device
        ty = lattice(args[6], stride, dev)
        tx = lattice(args[7], stride, dev)
        rec = check_kernel(K.SCORE_VOLUME_STRIDED, args, ty, tx)
        key = tuple(rec["shape"]) + (stride, stride)
        rec = {"name": f"score_volume_strided[{name}]", "route": "cuda",
               "source": SOURCE, "replaces": REPLACES_K2, "pair": True,
               "launches": k2_by[key],
               "launches_per_round": k2_by[key] / n_rounds,
               "captured_at_round": capture2.keyframe[name],
               "stride": stride, **rec}
        assert k2_by[key] == sim.R * n_rounds, (name, k2_by[key])
        records.append(rec)
        log(kernel_line(rec, ghz) + f" (round {rec['captured_at_round']}, "
            f"{rec['live_volumes']} live volumes, spread "
            f"{rec['spread_dy']:.4g}/{rec['spread_dx']:.4g})")
        for pr in check_probes(args, ty, tx, name):
            probe_records.append(pr)
            log(kernel_line(pr, ghz))
    for pr in probe_records:   # the main paths' counts: 0 by the asserts
        pr["launches"] = 0

    # --- 8. the exchange rounds up to the first inter-robot closure, on
    # the CPU ---
    t0 = time.perf_counter()
    first = next((k for k, (_, o, _) in enumerate(mlog["rounds"])
                  if any(x["inter_closures"] for x in o)), None)
    assert first is not None and first < MAX_CPU_ROUNDS, first
    _, _, clog = run_mr("cpu", max_ticks=mlog["rounds"][first][0] + 1)
    assert len(clog["rounds"]) == first + 1, (len(clog["rounds"]), first)
    for k, ((tc, oc, pc), (tg, og, pg)) in enumerate(
            zip(clog["rounds"], mlog["rounds"])):
        assert tc == tg and oc == og, (k, tc, oc, tg, og)
        for a, b in zip(pc, pg):
            d = a.astype(np.float64) - b
            d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
            assert np.all(np.abs(d) <= 1e-3), (k, np.abs(d).max())
    rounds = [o for _, o, _ in clog["rounds"]]
    assert all(o["foreign"] > 0 for o in rounds[0]), rounds[0]
    # a hypothesis enters a peer buffer only where the global search
    # matched a parked vertex (a vertex is parked and tried in one round)
    assert any(o["hypotheses"] > 0 for r in rounds for o in r), rounds
    assert any(o["inter_closures"] > 0 for o in rounds[-1]), rounds[-1]
    log(f"cpu replay: {first + 1} exchange rounds (ticks "
        f"{clog['rounds'][0][0]}..{clog['rounds'][-1][0]}), up to the first "
        f"inter-robot closure, agree with the card; outcomes "
        f"{rounds[-1]} in {time.perf_counter() - t0:.2f} s")

    # --- 9. the command line ---
    t0 = time.perf_counter()
    phase_cli(cfg, traj, fov, slam, kf_t)
    log(f"cli: phase 9 in {time.perf_counter() - t0:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": records + probe_records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
