"""Checkpoint and resume in the port (``pipeline/slam.py:state_from_g2o``,
``SingleRobotSlam.resume``) against the reference: the case of
``tests/test_resume.py:27-70`` (save mid-run, reload, keep keyframing).

The port runs the first 120 ticks and saves; both packages resume from that
file and feed the next 120 ticks. Bars and why:

* the reloaded state equals the saved one: vertex count, scans, poses
  within 1e-5 m / rad (the file holds 6 decimals);
* the reference's own checks hold on the port: keyframes append, poses
  stay finite, the last estimate within 1 m of the ground truth;
* the two packages' reloaded states are equal, and their continued runs
  agree as the whole-replay bars of ``tests/test_torch_pipeline.py`` say:
  poses within 1e-3 m / rad up to the first keyframe that accepts a
  closure, closures within ±1.

And the multi-robot resume (``mr/mrslam.py:mr_state_from_g2o``): the case
of ``tests/test_resume.py:115-194`` through both packages (its bars in its
docstring).
"""

import numpy as np
import torch

from cg_mrslam_tpu.config import Config as JConfig
from cg_mrslam_tpu.config import MatcherConfig as JMatcher
from cg_mrslam_tpu.config import SlamConfig as JSlamCfg
from cg_mrslam_tpu.pipeline.slam import SingleRobotSlam as JSlam
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch.config import Config, MatcherConfig, SlamConfig
from cg_mrslam_tpu_torch.io import g2o
from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

from torch_port_helpers import npy

torch.set_num_threads(1)

KW = dict(close_matcher=dict(extent=16.0, resolution=0.05,
                             kernel_radius=0.2),
          lc_matcher=dict(extent=24.0, resolution=0.1, kernel_radius=0.5),
          max_vertices=128, max_edges=512)
CUT = 120


def _cfg(config, matcher, slam_cfg):
    return config(slam=slam_cfg(min_inliers=4, window_loop_closure=8),
                  close_matcher=matcher(**KW["close_matcher"]),
                  lc_matcher=matcher(**KW["lc_matcher"]),
                  max_vertices=KW["max_vertices"],
                  max_edges=KW["max_edges"])


def test_save_resume_continue_matches_the_reference(tmp_path):
    cfg = _cfg(Config, MatcherConfig, SlamConfig)
    traj = JW.simulate_robot(JW.hospital_world(width=16.0, height=10.0,
                                               seed=2),
                             JW.corridor_waypoints(16.0, 10.0, 0, 1), seed=5,
                             beams=120, max_range=8.0)
    fov = 2 * np.pi * 0.75
    slam = SingleRobotSlam(cfg, 120, traj.gt[0], traj.ranges[0], fov, 8.0,
                           device="cpu")
    for t in range(1, CUT):
        slam.observe(traj.rel_odom[t - 1], traj.ranges[t])
    n_before = int(slam.state.graph.n_vertices)
    assert n_before > 10
    path = str(tmp_path / "ckpt.g2o")
    ids = (npy(slam.state.v_remote).astype(np.int64)
           + npy(slam.state.v_owner) * cfg.slam.base_id)
    g2o.save(path, slam.state.graph, ids=ids, scans=slam.state.scans)

    port = SingleRobotSlam.resume(cfg, path, device="cpu")
    ref = JSlam.resume(_cfg(JConfig, JMatcher, JSlamCfg), path)
    assert int(port.state.graph.n_vertices) == n_before
    np.testing.assert_allclose(npy(port.state.graph.poses)[:n_before],
                               npy(slam.state.graph.poses)[:n_before],
                               atol=1e-5)
    assert int(npy(port.state.scans.smask).sum()) == n_before
    for name in ("poses", "vmask", "fixed", "e_ij", "emask", "e_owner",
                 "e_level"):
        np.testing.assert_array_equal(npy(getattr(port.state.graph, name)),
                                      npy(getattr(ref.state.graph, name)))
    for name in ("v_owner", "v_remote"):
        np.testing.assert_array_equal(npy(getattr(port.state, name)),
                                      npy(getattr(ref.state, name)))
    np.testing.assert_array_equal(port._est, ref._est)

    end = min(CUT + 120, len(traj.gt))
    for t in range(CUT, end):
        port.observe(traj.rel_odom[t - 1], traj.ranges[t])
        ref.observe(traj.rel_odom[t - 1], traj.ranges[t])
    n_after = int(port.state.graph.n_vertices)
    assert n_after == int(ref.state.graph.n_vertices) > n_before
    p = npy(port.state.graph.poses)[npy(port.state.graph.vmask)]
    assert np.isfinite(p).all()
    err = np.asarray(port.infos[-1].pose)[:2] - traj.gt[end - 1][:2]
    assert np.hypot(*err) < 1.0, err
    closed = [k for k, i in enumerate(ref.infos) if i.closures_added]
    k = n_before + (closed[0] if closed else len(ref.infos))
    d = npy(port.state.graph.poses)[:k] - npy(ref.state.graph.poses)[:k]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= 1e-3, np.abs(d).max()
    assert abs(sum(i.closures_added for i in port.infos)
               - sum(i.closures_added for i in ref.infos)) <= 1


def test_mr_resume_keeps_the_own_edges_rule_as_the_reference(tmp_path):
    """``tests/test_resume.py:115-194`` through both packages: a hand-built
    two-robot state is saved; ``mr_state_from_g2o`` of each package
    reloads it with the edges' owners and levels, recovers
    ``out_closures`` from my closure onto the peer's vertex, and condenses
    the star it condensed before the save once the peer resends its closure
    list. Without the ``CGM_EDGE_META`` lines a re-received star is added
    beside the old one instead of replacing it, in both packages.

    Bars: the reloaded states equal (integers exact, poses 1e-6: both read
    the file's 6 decimals); the stars' ``z`` 1e-5 and information 1e-3
    (the reference's own bars for before/after), port against reference
    as in ``tests/test_torch_mr.py`` (``z`` 1e-4, information rtol 2e-2)."""
    import jax.numpy as jnp

    from cg_mrslam_tpu.config import MRConfig as JMRConfig
    from cg_mrslam_tpu.mr import mrslam as JMR
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.config import MRConfig
    from cg_mrslam_tpu_torch.core import graph as TG
    from cg_mrslam_tpu_torch.mr import mrslam as TMR
    from test_resume import _tiny_mr_state
    from test_torch_mr import _star_close
    from torch_port_helpers import CPU, assert_same_fields

    kw = dict(max_vertices=32, max_edges=64, max_beams=16)
    jcfg = JConfig(mr=JMRConfig(n_robots=2), **kw)
    cfg = Config(mr=MRConfig(n_robots=2), **kw)
    jst = _tiny_mr_state(jcfg)
    tst = convert.mr_state_from_numpy(convert.to_numpy(jst), CPU)
    jcl = JMR.ClosureList(idxs=jnp.asarray([2, 4], jnp.int32),
                          valid=jnp.asarray([True, True]))
    tcl = TMR.ClosureList(idxs=torch.tensor([2, 4], dtype=torch.int32),
                          valid=torch.tensor([True, True]),
                          dropped=torch.tensor(0, dtype=torch.int32))
    jst = JMR.receive_closure_list(jst, jnp.asarray(1, jnp.int32), jcl,
                                   jnp.asarray(True))
    tst = TMR.receive_closure_list(tst, 1, tcl, True)
    star_before = TMR.build_star(tst, 1)
    _star_close(star_before, JMR.build_star(jst, jnp.asarray(1, jnp.int32)))

    path = str(tmp_path / "mr.g2o")
    ids = (npy(tst.slam.v_remote).astype(np.int64)
           + npy(tst.slam.v_owner) * cfg.slam.base_id)
    g2o.save(path, tst.slam.graph, ids=ids, scans=tst.slam.scans)
    j2 = JMR.mr_state_from_g2o(jcfg, path, my_id=0)
    t2 = TMR.mr_state_from_g2o(cfg, path, my_id=0, device="cpu")
    assert_same_fields(t2, j2, atol=1e-6)
    g = t2.slam.graph
    em = npy(g.emask)
    assert (npy(g.e_owner)[em] == 1).sum() == 1      # the spliced star edge
    assert (npy(g.e_level)[em] == 2).sum() == 1
    assert npy(TG.own_edge_mask(g, 0))[em].sum() == em.sum() - 1
    assert bool(npy(t2.out_closures)[1, 6])          # slot 6 = peer kf 0

    # the peer resends its list (the protocol is resend-tolerant) and the
    # resumed robot condenses the same star
    j2 = JMR.receive_closure_list(j2, jnp.asarray(1, jnp.int32), jcl,
                                  jnp.asarray(True))
    t2 = TMR.receive_closure_list(t2, 1, tcl, True)
    star_after = TMR.build_star(t2, 1)
    np.testing.assert_array_equal(npy(star_after.valid),
                                  npy(star_before.valid))
    np.testing.assert_allclose(npy(star_after.z), npy(star_before.z),
                               atol=1e-5)
    np.testing.assert_allclose(npy(star_after.info), npy(star_before.info),
                               atol=1e-3)
    _star_close(star_after, JMR.build_star(j2, jnp.asarray(1, jnp.int32)))

    # without provenance the spliced edge reloads at level 0 and a
    # re-received star duplicates the peer's information
    stripped = str(tmp_path / "legacy.g2o")
    with open(path) as f, open(stripped, "w") as out:
        out.writelines(line for line in f
                       if not line.startswith("# CGM_EDGE_META"))
    j3 = JMR.mr_state_from_g2o(jcfg, stripped, my_id=0)
    t3 = TMR.mr_state_from_g2o(cfg, stripped, my_id=0, device="cpu")
    assert_same_fields(t3, j3, atol=1e-6)
    resend = dict(gauge=0, boundary=[1], z=[[1.0, 0.0, 0.0]],
                  info=[[100.0, 0, 0, 100.0, 0, 1000.0]], valid=[True])
    jmsg = JMR.StarMsg(**{k: jnp.asarray(v, jnp.int32 if k in (
        "gauge", "boundary") else None) for k, v in resend.items()})
    tmsg = convert.from_numpy(TMR.StarMsg, dict(
        convert.to_numpy(jmsg), dropped=np.int32(0)), CPU)
    for jst_, tst_, grow in ((j2, t2, 0), (j3, t3, 1)):
        n = int(npy(tst_.slam.graph.emask).sum())
        jb = JMR.receive_star(jst_, jnp.asarray(1, jnp.int32), jmsg,
                              jnp.asarray(True))
        tb = TMR.receive_star(tst_, 1, tmsg, True)
        assert int(npy(tb.slam.graph.emask).sum()) == n + grow
        assert_same_fields(tb, jb, atol=1e-6)
