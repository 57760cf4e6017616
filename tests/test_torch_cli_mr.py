"""``cg_mrslam --nRobots 2`` (all robots in one process) in the port's
command line against the reference's, at a small scale, each through its
package's ``main`` (the port's with ``device="cpu"``).

Bars (those of ``tests/test_torch_cli.py`` and of the scaled two-robot
replay in ``tests/test_torch_mr.py``):

* the same files: a ``.g2o`` and a map for each robot;
* per robot, equal ids in the ``.g2o`` (own and the peer's namespaced
  keyframes), own keyframe poses within 1e-3 m / rad up to the first round
  in which an inter-robot closure is accepted, ATE of the own keyframes
  within ±0.02 m, printed closures and accepted inter-robot closures within
  ±1, maps equal on ≥ 99% of their cells.
"""

import os

import numpy as np
import torch

from cg_mrslam_tpu import cli as jcli
from cg_mrslam_tpu.io import g2o as JIO
from cg_mrslam_tpu.mr.sim import MultiRobotSim as JSim
from cg_mrslam_tpu_torch import cli as tcli
from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim as TSim

from torch_port_helpers import ate, compare_maps, npy, run_cli

torch.set_num_threads(1)

ARGS = ["cg_mrslam", "--nRobots", "2", "--modality", "sim", "-o", "mr",
        "--ticks", "100", "--beams", "90", "--max-vertices", "64",
        "--max-edges", "256", "--world-width", "16", "--world-height", "10",
        "--max-range", "8", "--resolution", "0.05"]
BASE = 10000


def _spy(monkeypatch, cls, log):
    """Keep the simulator and the first tick after which some robot holds
    an accepted inter-robot closure."""
    exchange = cls.exchange_round

    def on_exchange(self, t, modality="sim"):
        exchange(self, t, modality)
        log["sim"] = self
        if log["first"] is None and any(
                npy(st.out_closures).any() for st in self.states):
            log["first"] = t

    monkeypatch.setattr(cls, "exchange_round", on_exchange)


def _summary(stdout):
    """``(vertices, closures, inter-robot accepted)`` a robot."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("robot ") and "vertices=" in line:
            f = dict(t.split("=") for t in line.split()[2:]
                     if "=" in t)
            out.append((int(f["vertices"]), int(f["closures"]),
                        int(f["accepted"])))
    return out


def test_cg_mrslam_matches_the_reference(tmp_path, monkeypatch):
    runs = {}
    for name, main, cls, kw in (("ref", jcli.main, JSim, {}),
                                ("port", tcli.main, TSim,
                                 {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        log = {"first": None}
        _spy(monkeypatch, cls, log)
        stdout, _ = run_cli(main, ARGS, d, monkeypatch, **kw)
        runs[name] = (d, _summary(stdout), log)
    (rd, rs, rl), (pd, ps, pl) = runs["ref"], runs["port"]
    names = sorted(os.listdir(rd))
    assert names == sorted(f"robot-{r}-mr{s}" for r in range(2)
                           for s in (".g2o", "-map.pgm", "-map.yaml"))
    assert sorted(os.listdir(pd)) == names
    assert len(ps) == len(rs) == 2
    for (rv, rc, ra), (pv, pc, pa) in zip(rs, ps):
        assert rv == pv and abs(rc - pc) <= 1 and abs(ra - pa) <= 1, (rs, ps)
    assert sum(a for _, _, a in ps) >= 1          # the robots met
    first = min(t for t in (rl["first"], pl["first"]) if t is not None)
    for r in range(2):
        a = JIO.load(str(rd / f"robot-{r}-mr.g2o"), native=False)
        b = JIO.load(str(pd / f"robot-{r}-mr.g2o"), native=False)
        np.testing.assert_array_equal(a.ids, b.ids)
        assert ((a.ids // BASE) == 1 - r).any()   # the peer's keyframes
        own = np.flatnonzero(a.ids // BASE == r)
        own = own[np.argsort(a.ids[own])]
        pa, pb = npy(a.graph.poses)[own], npy(b.graph.poses)[own]
        # ground truth at each own keyframe (the first pose first); the
        # keyframes before the first accepted inter-robot closure
        gt_r = np.asarray(rl["sim"].kf_gt[r])
        gt_p = np.asarray(pl["sim"].kf_gt[r])
        k = int((rl["sim"].trajs[r].gt[:first + 1, None]
                 == gt_r[None]).all(-1).any(0).sum())
        np.testing.assert_array_equal(gt_r[:k], gt_p[:k])
        d = pa[:k] - pb[:k]
        d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
        assert k > 3 and np.abs(d).max() <= 1e-3, (r, k, np.abs(d).max())
        assert abs(ate(pa, gt_r) - ate(pb, gt_p)) <= 0.02
        compare_maps(rd / f"robot-{r}-mr-map.pgm",
                     pd / f"robot-{r}-mr-map.pgm")
