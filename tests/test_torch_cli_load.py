"""``srslam --load`` (resume from a ``.g2o`` checkpoint) and
``--save-every-keyframe`` in the port's command line against the
reference's, at the small scale of ``tests/test_torch_cli.py``.

Both packages load the same checkpoint (written by the port's own
``srslam``) and run the same command; the bars are those of
``test_torch_cli.py``: the same files, equal ids, poses within 1e-3 m / rad
up to the first keyframe that accepts a closure, printed closures within
±1, maps equal on ≥ 99% of their cells. (A resumed run replays the route
from its start while its estimate starts at the newest keyframe, as the
reference's does, so ATE against the route says nothing here.)
"""

import os

import torch

from cg_mrslam_tpu import cli as jcli
from cg_mrslam_tpu_torch import cli as tcli
from cg_mrslam_tpu_torch.io import g2o

from torch_port_helpers import (compare_graph_files, compare_maps,
                                keyframe_lines, run_cli)

torch.set_num_threads(1)

SMALL = ["--beams", "90", "--max-vertices", "64", "--max-edges", "256",
         "--world-width", "16", "--world-height", "10", "--max-range", "8",
         "--resolution", "0.05"]


def test_srslam_load_matches_the_reference(tmp_path, monkeypatch):
    first = tmp_path / "first"
    first.mkdir()
    run_cli(tcli.main, ["srslam", "-o", "ck", "--ticks", "70",
                        "--save-every-keyframe", "--no-map"] + SMALL,
            first, monkeypatch, device="cpu")
    ck = first / "robot-0-ck.g2o"
    n0 = int(g2o.load(str(ck), device="cpu").graph.n_vertices)
    assert n0 > 10
    out = {}
    for name, main, kw in (("ref", jcli.main, {}),
                           ("port", tcli.main, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        stdout, _ = run_cli(main, ["srslam", "-o", "r", "--load", str(ck),
                                   "--ticks", "90"] + SMALL, d, monkeypatch,
                            **kw)
        assert f"resumed from {ck}: {n0} vertices" in stdout
        out[name] = (d, keyframe_lines(stdout))
    (rd, rk), (pd, pk) = out["ref"], out["port"]
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd))
    assert len(rk) == len(pk) > 0
    closed = [k for k, (_, c) in enumerate(rk) if c > 0]
    compare_graph_files(rd / "robot-0-r.g2o", pd / "robot-0-r.g2o",
                        n0 + closed[0] if closed else None)
    assert abs(sum(c for _, c in rk) - sum(c for _, c in pk)) <= 1
    compare_maps(rd / "robot-0-r-map.pgm", pd / "robot-0-r-map.pgm")


def test_save_every_keyframe_checkpoints_during_the_run(tmp_path,
                                                        monkeypatch):
    """With ``--save-every-keyframe`` the checkpoint is rewritten after
    every keyframe, on the writer thread (the reference's cadence)."""
    writes = []
    orig = g2o.save

    def spy(path, graph, **kw):
        writes.append(int(graph.n_vertices))
        assert graph.poses.device.type == "cpu"   # copied before the thread
        return orig(path, graph, **kw)

    monkeypatch.setattr(g2o, "save", spy)
    stdout, _ = run_cli(tcli.main, ["srslam", "-o", "ck", "--ticks", "60",
                                    "--save-every-keyframe", "--no-map"]
                        + SMALL, tmp_path, monkeypatch, device="cpu")
    n_kf = len(keyframe_lines(stdout))
    # one write a keyframe, then the end-of-run save of the final graph
    assert writes == list(range(2, n_kf + 2)) + [n_kf + 1]
    assert int(g2o.load(str(tmp_path / "robot-0-ck.g2o"),
                        device="cpu").graph.n_vertices) == n_kf + 1
