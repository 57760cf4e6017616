"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (nothing is caught; any failure ends the run with a traceback):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build the score-volume kernel (``csrc/score_volume.cu``) with nvcc;
3. the slice: the ``srslam`` default deployment (40 x 20 m hospital world,
   seed 0, 2 loops, 360 beams, 10 m range, capacity 512/2048, close grid
   30 m at 0.025 m, LC grid 70 m at 0.1 m) through ``SingleRobotSlam`` on
   the card, up to capacity - 2 keyframes, with the kernel's launch counts
   set to 0 just before and read just after; checks launches = 3 per
   keyframe, finite chi2, at least one accepted closure, ATE below the
   odometry-only ATE; prints ATE and keyframe latency p50/p99 per bucket;
4. the kernel at the three main-path shapes (close, near, loop), on the
   inputs of the first call of each shape in the slice whose volume depends
   on where the points land (a grid that is not constant under kept points,
   and a score that varies along both offset axes): against its plain
   PyTorch version (rtol 1e-5, atol 1e-6), both timed with CUDA events;
5. the first 20 keyframes replayed on the CPU (plain versions), poses
   against the card's.

The card's line comes again just before the ``kernels`` JSON record, which is
the line before last; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

RTOL, ATOL = 1e-5, 1e-6
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_CPU_KEYFRAMES = 20
# a volume that varies by less than this along an offset axis cannot tell a
# kernel that reads the right cells from one that does not
MIN_SPREAD = 100 * ATOL
SHAPES = {"close": (65, 12, 12), "near": (17, 3, 3), "loop": (65, 15, 5)}
REPLACES = "cg_mrslam_tpu/ops/correlate.py:189 (_make_kernel_v3 via " \
           "pallas_score_volume, :477; pallas_call at :454)"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def shape_name(t, ry, rx) -> str:
    return next(k for k, v in SHAPES.items() if v == (t, ry, rx))


def live_volumes(grids, gidx, keep) -> torch.Tensor:
    """``[B]``: volume ``b`` keeps points and its grid is not constant."""
    flat = grids.flatten(1)
    varied = (flat.amax(1) > flat.amin(1))[gidx.long()]
    return varied & keep.flatten(1).any(1)


def spreads(vol, live):
    """Largest spread of the live volumes of ``vol [B,T,Dy,Dx]`` along Dy
    and along Dx (0 when no volume is live)."""
    if not bool(live.any()):
        return 0.0, 0.0
    v = vol[live]
    return (float((v.amax(2) - v.amin(2)).max()),
            float((v.amax(3) - v.amin(3)).max()))


class Capture:
    """Stands in for the kernel wrapper inside ``matcher.search``. It
    launches through the real wrapper, so the launch counts are the
    wrapper's own, and keeps a copy of the inputs of the first call of each
    shape whose volume depends on where the points land — on inputs where
    every score is the same constant, a kernel that ignored its offsets or
    misread its grid index would still agree with the plain version."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls = {}      # shape name -> kernel inputs
        self.pending = {}    # shape name -> (kernel inputs, output)
        self.keyframe = {}   # shape name -> keyframe it was captured at

    @property
    def armed(self) -> bool:
        return len(self.calls) < len(SHAPES)

    def __call__(self, *args):
        out = self.kernel(*args)
        name = shape_name(args[2].shape[1], args[6], args[7])
        if name not in self.calls:
            self.pending[name] = (tuple(a.clone() if torch.is_tensor(a)
                                        else a for a in args), out.clone())
        return out

    def settle(self, keyframe: int) -> None:
        """After a keyframe (outside its clock): keep the pending calls
        that are live."""
        for name, (args, out) in self.pending.items():
            live = live_volumes(args[0], args[1], args[4])
            if min(spreads(out, live)) >= MIN_SPREAD:
                self.calls[name] = args
                self.keyframe[name] = keyframe
        self.pending.clear()


def srslam_setup():
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = Config(
        slam=SlamConfig(linear_update=0.25, angular_update=math.pi / 4,
                        min_inliers=7, window_loop_closure=10,
                        inlier_threshold=2.0),
        mr=MRConfig(n_robots=1),
        close_matcher=MatcherConfig(extent=30.0, resolution=0.025,
                                    kernel_radius=0.2, max_score=0.15),
        lc_matcher=MatcherConfig(extent=70.0, resolution=0.1,
                                 kernel_radius=0.5, max_score=0.15),
        max_vertices=512, max_edges=2048)
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


def cuda_ms(fn, reps=20) -> float:
    for _ in range(3):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_kernel(kernel, args):
    """Kernel vs plain on one captured call; returns the record."""
    from cg_mrslam_tpu_torch.ops.correlate import volume_plain

    grids, gidx, ix, iy, keep, count, ry, rx = args
    dev = grids.device
    ty = torch.arange(-ry, ry + 1, dtype=torch.int32, device=dev)
    tx = torch.arange(-rx, rx + 1, dtype=torch.int32, device=dev)
    got = kernel(*args)
    want = volume_plain(grids, gidx, ix, iy, keep, count, ty, tx)
    torch.cuda.synchronize()
    # the inputs must make the comparison able to fail: some volume with
    # kept points on a grid that is not constant, whose plain scores vary
    # along both offset axes
    live = live_volumes(grids, gidx, keep)
    spread_y, spread_x = spreads(want, live)
    assert min(spread_y, spread_x) >= MIN_SPREAD, (spread_y, spread_x)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: volume_plain(grids, gidx, ix, iy, keep,
                                            count, ty, tx), reps=5)
    b, t, p = ix.shape
    n_off = (2 * ry + 1) * (2 * rx + 1)
    # the function's own inputs, each read once — the grids it scores,
    # points [P,2] f32, valid [B,P] bool, bases [B,3] f32, thetas [T] f32 —
    # and its output written once; the cells, keep mask and count are
    # intermediates of the split between torch code and the kernel
    n_grids = int(torch.unique(gidx).numel())
    n_bytes = (n_grids * grids[0].numel() * 4 + p * 2 * 4 + b * p
               + b * 3 * 4 + t * 4 + b * t * n_off * 4)
    n_ops = int(keep.sum()) * n_off + b * t * n_off   # adds + divides
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"shape": [b, t, 2 * ry + 1, 2 * rx + 1], "points": p,
            "grid_cells": grids.shape[-1], "grids": n_grids,
            "live_volumes": int(live.sum()),
            "spread_dy": spread_y, "spread_dx": spread_x,
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import cg_mrslam_tpu_torch.matcher.search as search
    from cg_mrslam_tpu_torch.ops import correlate as K

    # --- 1. the card ---
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    # --- 2. build ---
    t0 = time.perf_counter()
    K.build()
    K.SCORE_VOLUME.load()
    log(f"build: score_volume.cu in {time.perf_counter() - t0:.2f} s")

    # --- 3. the slice on the card ---
    t0 = time.perf_counter()
    cfg, traj, fov = srslam_setup()
    log(f"sim: {len(traj.gt)} ticks, {traj.ranges.shape[1]} beams in "
        f"{time.perf_counter() - t0:.2f} s")
    capture = Capture(K.SCORE_VOLUME)
    search.SCORE_VOLUME = capture
    K.SCORE_VOLUME.launches = 0
    K.SCORE_VOLUME.launches_by_shape.clear()
    t0 = time.perf_counter()
    slam, kf_t, lat = run_slice(cfg, traj, fov, "cuda", capture=capture)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.SCORE_VOLUME.launches
    by_shape = dict(K.SCORE_VOLUME.launches_by_shape)
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
    for b in sorted(lat):
        v = np.asarray(lat[b]) * 1e3
        log(f"slice: bucket {b}: {len(v)} keyframes, latency p50 "
            f"{np.percentile(v, 50):.2f} ms, p99 {np.percentile(v, 99):.2f} "
            f"ms, max {v.max():.2f} ms")
    assert n_kf >= 300, n_kf
    assert 512 in lat and 256 in lat, sorted(lat)
    assert launches == 3 * n_kf, (launches, n_kf)
    assert all(np.isfinite(i.chi2) for i in infos)
    assert closures >= 1, closures
    assert ate_slam < ate_odom, (ate_slam, ate_odom)

    # --- 4. the kernel at the main-path shapes ---
    assert sorted(capture.calls) == sorted(SHAPES), sorted(capture.calls)
    records = []
    for name in SHAPES:
        rec = check_kernel(K.SCORE_VOLUME, capture.calls[name])
        key = tuple(rec["shape"])
        rec = {"name": f"score_volume[{name}]", "route": "cuda",
               "source": "cg_mrslam_tpu_torch/csrc/score_volume.cu",
               "replaces": REPLACES, "launches": by_shape[key],
               "launches_per_keyframe": by_shape[key] / n_kf,
               "captured_at_keyframe": capture.keyframe[name], **rec}
        assert by_shape[key] == n_kf, (name, by_shape[key], n_kf)
        records.append(rec)
        log(f"kernel {rec['name']} {rec['shape']} (keyframe "
            f"{rec['captured_at_keyframe']}, {rec['live_volumes']} live "
            f"volumes, spread {rec['spread_dy']:.4g}/{rec['spread_dx']:.4g}):"
            f" {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}), max_abs_err "
            f"{rec['max_abs_err']:.3g}")

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

    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
