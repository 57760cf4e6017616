"""Parity of the port's keyframe pipeline (``pipeline/graph_dist.py``,
``closure.py``, ``slam.py``, ``sim/world.py``) with ``cg_mrslam_tpu``,
function by function and for the slice as a whole.

The slice test replays the same simulated scans through the reference's
``SingleRobotSlam`` and the port's on the CPU, at a scaled config (one
bucket, so one reference compile). Bars and why:

* scans from the port's simulator equal the reference's within 1e-5 m
  (both ray-cast in float32), but for a bounded share of grazing hits
  (see the test);
* up to the first accepted loop closure every keyframe's optimized pose
  agrees within 1e-3 m / 1e-3 rad and ``sm_accepted`` is equal — odometry
  chains solve to the same answer up to float32 noise;
* over the whole replay, ATE against ground truth agrees within 0.02 m and
  the total of ``closures_added`` within ±1: after closures, a near-tie in
  a score volume can move one match by one lattice step on float32 noise
  (the reference documents the same sensitivity between its own solver
  paths, ``solver/gauss_newton.py:212-218``), so the end bars are on map
  quality, not identical structure.

One keyframe from an identical mid-run state (handed across with
``convert.py``) must reproduce the reference's discrete decisions exactly
and its poses to 1e-4 m.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.config import Config, MatcherConfig, SlamConfig
from cg_mrslam_tpu.pipeline import closure as JCL
from cg_mrslam_tpu.pipeline import graph_dist as JGD
from cg_mrslam_tpu.pipeline import slam as JSL
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import config as tconfig
from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.core import graph as TG
from cg_mrslam_tpu_torch.pipeline import closure as TCL
from cg_mrslam_tpu_torch.pipeline import graph_dist as TGD
from cg_mrslam_tpu_torch.pipeline import slam as TSL
from cg_mrslam_tpu_torch.sim import world as TW
from torch_port_helpers import CPU, assert_same_fields, jf, npy, port, tf

torch.set_num_threads(1)

CFG_KW = dict(max_vertices=64, max_edges=256)
BEAMS, MAX_RANGE, FOV = 120, 8.0, 2 * np.pi * 0.75


def _cfgs():
    """The same scaled config in both packages (``tests/test_srslam.py``'s
    world and matchers, capacity 64)."""
    def build(m):
        return m.Config(
            slam=m.SlamConfig(min_inliers=4, window_loop_closure=8),
            close_matcher=m.MatcherConfig(extent=16.0, resolution=0.05,
                                          kernel_radius=0.2),
            lc_matcher=m.MatcherConfig(extent=24.0, resolution=0.1,
                                       kernel_radius=0.5),
            **CFG_KW)

    class Ref:
        Config, SlamConfig, MatcherConfig = Config, SlamConfig, MatcherConfig

    return build(Ref), build(tconfig)


def _trajectories():
    args = dict(seed=5, beams=BEAMS, max_range=MAX_RANGE,
                odom_noise=(0.02, 0.008))
    jworld = JW.hospital_world(width=16.0, height=10.0, seed=2)
    tworld = TW.hospital_world(width=16.0, height=10.0, seed=2)
    wps = JW.corridor_waypoints(16.0, 10.0, robot=0, n_loops=1)
    return (JW.simulate_robot(jworld, wps, **args),
            TW.simulate_robot(tworld, wps, device="cpu", **args),
            jworld, tworld)


def _replay(slam, traj, cap, max_keyframes=None):
    """Feed the trajectory (up to ``cap`` - 2 vertices or ``max_keyframes``
    keyframes); record each keyframe's (state, est, ranges) going in and
    the gt pose of the keyframe."""
    calls = []
    step = slam.runner.step

    def recording(state, est, ranges):
        calls.append((state, np.array(est), np.array(ranges)))
        return step(state, est, ranges)

    slam.runner.step = recording
    kf_gt = [traj.gt[0]]
    for t in range(1, len(traj.gt)):
        if slam.observe(traj.rel_odom[t - 1], traj.ranges[t]):
            kf_gt.append(traj.gt[t])
        if (int(slam.state.graph.n_vertices) >= cap - 2
                or len(slam.infos) == max_keyframes):
            break
    return calls, np.asarray(kf_gt)


@pytest.fixture(scope="module")
def replays():
    jcfg, tcfg = _cfgs()
    jtraj, ttraj, jworld, tworld = _trajectories()
    jslam = JSL.SingleRobotSlam(jcfg, BEAMS, jtraj.gt[0], jtraj.ranges[0],
                                fov=FOV, max_range=MAX_RANGE)
    jcalls, kf_gt = _replay(jslam, jtraj, jcfg.max_vertices)
    # both packages see the reference's scans, so only the pipelines differ
    tslam = TSL.SingleRobotSlam(tcfg, BEAMS, jtraj.gt[0], jtraj.ranges[0],
                                fov=FOV, max_range=MAX_RANGE, device="cpu")
    tcalls, tkf_gt = _replay(tslam, jtraj, tcfg.max_vertices)
    return dict(jcfg=jcfg, tcfg=tcfg, jtraj=jtraj, ttraj=ttraj,
                jworld=jworld, tworld=tworld, jslam=jslam, tslam=tslam,
                jcalls=jcalls, tcalls=tcalls, kf_gt=kf_gt, tkf_gt=tkf_gt)


def test_simulated_scans_match(replays):
    j, t = replays["jtraj"], replays["ttraj"]
    np.testing.assert_array_equal(replays["tworld"].segments,
                                  replays["jworld"].segments)
    np.testing.assert_array_equal(t.gt, j.gt)
    np.testing.assert_array_equal(t.odom, j.odom)
    np.testing.assert_array_equal(t.rel_odom, j.rel_odom)
    # ranges: both ray-cast in float32, but XLA contracts the cross
    # products of the intersection into fused multiply-adds and torch does
    # not, so a few rounding steps differ; a hit at grazing incidence (a
    # small denominator) amplifies that. The bar is 1e-5 m; a bounded share
    # of grazing hits (measured 5 of 28680) may exceed it, by at most 5e-5.
    d = np.abs(t.ranges.astype(np.float64) - j.ranges)
    assert np.mean(d > 1e-5) <= 1e-3, np.sort(d.ravel())[-10:]
    assert d.max() <= 5e-5, d.max()


def _ate(est, gt):
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
    return float(np.sqrt(np.mean(np.sum((aligned[:, :2] - gt[:, :2]) ** 2,
                                        axis=1))))


def test_slice_replay_matches_reference(replays):
    ji, ti = replays["jslam"].infos, replays["tslam"].infos
    assert len(ti) == len(ji) > 40
    np.testing.assert_array_equal(replays["tkf_gt"], replays["kf_gt"])
    first = next(k for k in range(len(ji))
                 if ji[k].closures_added or ti[k].closures_added)
    assert first > 10
    for k in range(first):
        assert ti[k].sm_accepted == ji[k].sm_accepted, k
        d = np.asarray(ti[k].pose, np.float64) - np.asarray(ji[k].pose)
        assert np.all(np.abs(d[:2]) <= 1e-3), (k, d)
        assert abs((d[2] + np.pi) % (2 * np.pi) - np.pi) <= 1e-3, (k, d)
    jc = sum(i.closures_added for i in ji)
    tc = sum(i.closures_added for i in ti)
    assert jc > 0 and abs(tc - jc) <= 1, (tc, jc)
    assert all(np.isfinite(i.chi2) for i in ti)
    assert all(i.solver_backend == 0 for i in ti)
    gt = replays["kf_gt"]
    ate_j = _ate(np.asarray(replays["jslam"].poses), gt)
    ate_t = _ate(replays["tslam"].poses, gt)
    assert abs(ate_t - ate_j) <= 0.02, (ate_t, ate_j)


def test_keyframe_step_from_identical_state(replays):
    """The step that accepted the reference's first windowed closure, from
    the reference's own state going into it."""
    ji = replays["jslam"].infos
    k = next(k for k in range(len(ji)) if ji[k].closures_added
             and bool(np.asarray(replays["jcalls"][k][0].buffer.mask).any()))
    jstate, est, ranges = replays["jcalls"][k]
    jnext = (replays["jcalls"][k + 1][0] if k + 1 < len(ji)
             else replays["jslam"].state)
    tstate = convert.state_from_numpy(convert.state_to_numpy(jstate), CPU)
    assert_same_fields(tstate, jstate)
    n_live = int(jstate.graph.n_vertices)
    e_live = ji[k - 1].n_edges
    tnext, tinfo = TSL.keyframe_step_bucketed(tstate, est, ranges,
                                              replays["tcfg"], n_live, e_live)
    jinfo = ji[k]
    for f in ("sm_accepted", "closures_added", "n_edges", "regions_dropped",
              "solver_backend"):
        assert getattr(tinfo, f) == getattr(jinfo, f), f
    np.testing.assert_allclose(tinfo.pose, jinfo.pose, atol=1e-4)
    np.testing.assert_allclose(tinfo.chi2, jinfo.chi2, rtol=1e-3, atol=1e-3)
    tn, jn = convert.state_to_numpy(tnext), convert.state_to_numpy(jnext)
    for key in ("graph.vmask", "graph.emask", "graph.e_ij", "graph.e_owner",
                "buffer.mask", "buffer.v_old", "buffer.v_new", "buffer.age",
                "v_owner", "v_remote", "scans.smask"):
        np.testing.assert_array_equal(tn[key], jn[key], err_msg=key)
    for key, tol in (("graph.poses", 1e-4), ("graph.e_z", 1e-4),
                     ("scans.ranges", 0.0)):
        np.testing.assert_allclose(tn[key], jn[key], atol=tol, err_msg=key)


def test_graph_dist_functions(replays):
    jstate = replays["jcalls"][-1][0]
    jg = jstate.graph
    tg = port(jg, TG.PoseGraph)
    cur = int(jg.n_vertices) - 1
    jd = JGD.bounded_distances(jg, jnp.int32(cur))
    td = TGD.bounded_distances(tg, torch.tensor(cur))
    np.testing.assert_allclose(npy(td), npy(jd), rtol=1e-5)
    js = JGD.candidate_sets(jg, jnp.int32(cur), jd)
    ts = TGD.candidate_sets(tg, torch.tensor(cur), td)
    np.testing.assert_array_equal(npy(ts.near), npy(js.near))
    np.testing.assert_array_equal(npy(ts.loop), npy(js.loop))
    cand = npy(js.near) | npy(js.loop)
    cand[::7] = False   # split the set into several components
    jl = JGD.components(jg, jnp.asarray(cand))
    tl = TGD.components(tg, torch.as_tensor(cand))
    np.testing.assert_array_equal(npy(tl), npy(jl))
    assert len(np.unique(npy(jl)[cand])) > 1
    vo, vr = npy(jstate.v_owner), npy(jstate.v_remote)
    je = JGD.expand_neighbors(jnp.asarray(cand), jf(vo), jf(vr), jg.vmask,
                              n_robots=2, gap=3)
    te = TGD.expand_neighbors(torch.as_tensor(cand), tf(vo), tf(vr),
                              tg.vmask, n_robots=2, gap=3)
    np.testing.assert_array_equal(npy(te), npy(je))
    for k in (2, 4):
        jr = JGD.pick_regions(jg, jnp.asarray(cand), jl, jnp.int32(cur), k)
        tr = TGD.pick_regions(tg, torch.as_tensor(cand), tl,
                              torch.tensor(cur), k)
        for a, b in zip(tr, jr):
            np.testing.assert_array_equal(npy(a), npy(b))


def _hypotheses(rng, poses, n_in=5, n_out=4):
    """Consistent hypotheses (true relative pose + noise) and outliers."""
    from cg_mrslam_tpu.utils import se2

    n = poses.shape[0]
    vo = rng.integers(0, n // 2, n_in + n_out).astype(np.int32)
    vn = rng.integers(n // 2, n, n_in + n_out).astype(np.int32)
    z = np.array(se2.relative(jf(poses[vo]), jf(poses[vn])), np.float32)
    z[:n_in] += rng.normal(0, 0.01, (n_in, 3)).astype(np.float32)
    z[n_in:] += rng.uniform(-2, 2, (n_out, 3)).astype(np.float32)
    info = np.tile(np.array([1000, 0, 0, 1000, 0, 10000], np.float32),
                   (n_in + n_out, 1))
    return vo, vn, z, info


@pytest.mark.parametrize("seed", [0, 1])
def test_closure_buffer_and_vote(seed):
    rng = np.random.default_rng(seed)
    poses = np.concatenate([rng.uniform(-5, 5, (20, 2)),
                            rng.uniform(-3, 3, (20, 1))], 1).astype(
                                np.float32)
    jb, tb = JCL.empty(12), TCL.empty(12, CPU)
    assert_same_fields(jb, tb)
    window = 3
    for step in range(4):
        vo, vn, z, info = _hypotheses(rng, poses)
        valid = rng.uniform(size=len(vo)) > 0.2
        jb = JCL.insert(jb, jf(vo), jf(vn), jf(z), jf(info),
                        jnp.asarray(valid))
        tb = TCL.insert(tb, tf(vo), tf(vn), tf(z), tf(info),
                        torch.as_tensor(valid))
        assert_same_fields(jb, tb)
        jv = JCL.consistency_vote(jb, jf(poses), inlier_threshold=2.0,
                                  min_inliers=3)
        tv = TCL.consistency_vote(tb, tf(poses), inlier_threshold=2.0,
                                  min_inliers=3)
        for a, b in zip(tv, jv):
            np.testing.assert_array_equal(npy(a), npy(b))
        jb2, jacc, _ = JCL.windowed_vote(jb, jf(poses), window=window,
                                         inlier_threshold=2.0, min_inliers=3)
        tb2, tacc, _ = TCL.windowed_vote(tb, tf(poses), window=window,
                                         inlier_threshold=2.0, min_inliers=3)
        np.testing.assert_array_equal(npy(tacc), npy(jacc))
        assert_same_fields(jb2, tb2)
        jg = JSL.init_state(_cfgs()[0], 8, np.zeros(3), np.ones(8), 1.0,
                            5.0).graph
        tg = port(jg, TG.PoseGraph)
        assert_same_fields(JCL.add_accepted(jg, jb, jacc, owner=1),
                           TCL.add_accepted(tg, tb, tacc, owner=1))
        jb, tb = jb2, tb2
    np.testing.assert_array_equal(npy(TCL.tick(tb, 2).mask),
                                  npy(JCL.tick(jb, 2).mask))


def test_lattice_topk():
    rng = np.random.default_rng(3)
    q = np.array([0.5, 0.5, 0.2], np.float32)
    poses = np.concatenate([rng.uniform(-1, 1, (16, 2)),
                            rng.uniform(-4, 4, (16, 1))], 1).astype(
                                np.float32)
    poses[5] = poses[1] + 0.01          # same merge cell as an earlier one
    scores = np.sort(rng.uniform(0, 0.3, 16)).astype(np.float32)
    want = JSL._lattice_topk(jf(poses), jf(scores), jf(q), 3)
    got = TSL._lattice_topk(tf(poses), tf(scores), tf(q), 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(npy(a), npy(b))


def test_init_state_defaults_to_the_card():
    """Entry points run on the card unless the caller names the CPU; with
    no card the default raises instead of falling back."""
    tcfg = _cfgs()[1]
    args = (tcfg, 8, np.zeros(3), np.ones(8, np.float32), 1.0, 5.0)
    if torch.cuda.is_available():
        assert TSL.init_state(*args).graph.poses.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSL.init_state(*args)
    jstate = JSL.init_state(_cfgs()[0], *args[1:])
    assert_same_fields(TSL.init_state(*args, device="cpu"), jstate)


def _big_cfgs(n=300, e=1200):
    """The test config at a capacity above the smallest bucket (256)."""
    return [dataclasses.replace(c, max_vertices=n, max_edges=e)
            for c in _cfgs()]


def test_bucket_plumbing_matches_reference(replays):
    """Bucket choice, slicing and splicing decide which slice of the state
    a step sees; they must be the reference's exactly."""
    jtraj = replays["jtraj"]
    for n, e in ((300, 1200), (512, 2048)):
        jcfg, tcfg = _big_cfgs(n, e)
        args = (BEAMS, jtraj.gt[0], jtraj.ranges[0], FOV, MAX_RANGE)
        jstate = JSL.init_state(jcfg, *args)
        tstate = TSL.init_state(tcfg, *args, device="cpu")
        for n_live in (1, 100, 255, 256, 300, n - 2):
            for e_live in (0, 500, 900, 1500):
                assert (TSL._bucket_pair(tstate, n_live, e_live)
                        == JSL._bucket_pair(jstate, n_live, e_live))
        nb, eb = TSL._bucket_pair(tstate, 1, 0)
        assert (nb, eb) == (256, 1024)
        jpart = JSL._slice_state(jstate, nb, eb)
        tpart = TSL._slice_state(tstate, nb, eb)
        assert_same_fields(tpart, jpart)
        rng = np.random.default_rng(n)
        poses = rng.uniform(-5, 5, (nb, 3)).astype(np.float32)
        jpart = dataclasses.replace(jpart, graph=dataclasses.replace(
            jpart.graph, poses=jf(poses), n_vertices=jnp.int32(7)))
        tpart = dataclasses.replace(tpart, graph=dataclasses.replace(
            tpart.graph, poses=tf(poses), n_vertices=torch.tensor(7)))
        assert_same_fields(TSL._merge_state(tstate, tpart),
                           JSL._merge_state(jstate, jpart))


def test_sliced_step_equals_full_step(replays):
    """Below the smallest bucket the step runs on a 256-vertex slice of a
    300-vertex state; the result must be the full-state step's (float32
    noise of the larger factorization aside)."""
    jtraj = replays["jtraj"]
    tcfg = _big_cfgs()[1]
    slam = TSL.SingleRobotSlam(tcfg, BEAMS, jtraj.gt[0], jtraj.ranges[0],
                               fov=FOV, max_range=MAX_RANGE, device="cpu")
    calls, _ = _replay(slam, jtraj, tcfg.max_vertices, max_keyframes=12)
    state, est, ranges = calls[-1]
    n_live, e_live = slam.runner.n_live - 1, slam.infos[-2].n_edges
    assert TSL._bucket_pair(state, n_live, e_live)[0] == 256 < 300
    sliced, info_s = TSL.keyframe_step_bucketed(state, est, ranges, tcfg,
                                                n_live, e_live)
    full, info_f = TSL.keyframe_step(state, torch.from_numpy(est),
                                     torch.from_numpy(ranges), tcfg)
    assert info_s.sm_accepted == bool(info_f.sm_accepted)
    assert info_s.n_edges == int(info_f.n_edges)
    np.testing.assert_allclose(info_s.pose, npy(info_f.pose), atol=1e-5)
    a, b = convert.state_to_numpy(sliced), convert.state_to_numpy(full)
    for key in a:
        if a[key].dtype.kind == "f":
            np.testing.assert_allclose(a[key], b[key], atol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)

