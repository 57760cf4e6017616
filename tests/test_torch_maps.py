"""Parity of the port's occupancy maps (``maps/occupancy.py``) with
``cg_mrslam_tpu``: the cases of ``tests/test_occupancy.py`` through both
packages on the same numpy inputs.

Bars and why:

* hit and miss counts: the same totals, and equal cell for cell except in
  at most 0.1% of the cells, each off by at most two samples (two misses,
  or two ``gain`` hits). Both packages step along each ray in float32, but
  XLA contracts ``origin + dir·t`` into a fused multiply-add where torch
  rounds twice, so a sample or endpoint within an ulp of a cell boundary
  can fall into the neighbouring cell. The simulated world's walls lie
  exactly on cell boundaries (multiples of 0.05 m), so two beams that end
  on one wall cell can move together: the ``sim`` case has 50 such cells
  of 160 000, two of them off by two samples. A count is moved, never made
  or lost, hence the equal totals;
* ``threshold`` of the same grids is equal; the ``.pgm/.yaml`` pair of the
  same trinary map is byte-identical;
* the reference test's own semantic checks (free along a ray, occupied at
  its end, infinity filling, splat, robot footprint, map base rotation,
  walls of the simulated world) hold on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core import scan as JS
from cg_mrslam_tpu.maps import occupancy as JOCC
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.maps import occupancy as OCC

from torch_port_helpers import npy, port

torch.set_num_threads(1)


def _one_beam_scans():
    scans = JS.empty(4, 8, first_beam_angle=0.0, angular_step=0.1,
                     max_range=5.0)
    ranges = np.full(8, 5.0, np.float32)
    ranges[0] = 2.0
    return JS.set_scan(scans, 0, jnp.asarray(ranges))


def _sim_scans():
    """test_occupancy.py's corridor poses in the 16 x 10 world."""
    world = JW.hospital_world(width=16.0, height=10.0, seed=2)
    beams, fov, mr = 180, 2 * np.pi * 0.75, 8.0
    gt = np.array([[5, 5, 0], [7, 5, 0], [9, 5, np.pi / 2],
                   [11, 5, np.pi]], np.float32)
    scans = JS.empty(8, beams, first_beam_angle=-fov / 2,
                     angular_step=fov / beams, max_range=mr)
    for k, p in enumerate(gt):
        r = JW.raycast(world.as_jax(), jnp.asarray(p), beams, -fov / 2,
                       fov / beams, mr)
        scans = JS.set_scan(scans, k, r)
    poses = np.zeros((8, 3), np.float32)
    poses[:4] = gt
    return poses, scans


CASES = {
    "single_beam": dict(cells=128, resolution=0.1, max_range=5.0),
    "infinity_fill": dict(cells=128, resolution=0.1, max_range=5.0,
                          infinity_filling_range=3.0),
    "square": dict(cells=128, resolution=0.1, max_range=5.0,
                   square_size=1),
    "robot_fill": dict(cells=128, resolution=0.1, max_range=5.0,
                       robot_fill=4),
    "no_robot_fill": dict(cells=128, resolution=0.1, max_range=5.0,
                          robot_fill=-1),
    "angle": dict(cells=128, resolution=0.1, max_range=5.0, robot_fill=4,
                  angle=float(np.pi / 2)),
    "usable": dict(cells=128, resolution=0.1, max_range=5.0,
                   usable_range=1.5, infinity_filling_range=4.0),
    "sim": dict(cells=400, resolution=0.05, max_range=8.0,
                infinity_filling_range=5.0),
}


def _inputs(case):
    if case == "sim":
        poses, scans = _sim_scans()
        return poses, scans, np.asarray([8.0, 5.0], np.float32)
    poses = np.zeros((4, 3), np.float32)
    if case in ("robot_fill", "no_robot_fill", "angle"):
        poses[0, :2] = 1.0
    return poses, _one_beam_scans(), np.zeros(2, np.float32)


def _both(case):
    poses, scans, center = _inputs(case)
    kw = CASES[case]
    want = JOCC.integrate(jnp.asarray(poses), scans, jnp.asarray(center),
                          **kw)
    got = OCC.integrate(torch.as_tensor(poses), port(scans, S.ScanSet),
                        torch.as_tensor(center), **kw)
    return got, want


def _assert_counts_close(got, want, unit):
    """The same total; equal but for ≤ 0.1% of the cells, each off by at
    most two samples of ``unit``."""
    a, b = npy(got), npy(want)
    assert a.sum() == b.sum()
    d = np.abs(a - b)
    assert (d > 0).mean() <= 1e-3, (d > 0).sum()
    assert d.max() <= 2 * unit, d.max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_integrate_matches_the_reference(case):
    got, want = _both(case)
    _assert_counts_close(got.misses, want.misses, 1.0)
    _assert_counts_close(got.hits, want.hits,
                         CASES[case].get("gain", 3.0))
    assert float(npy(got.hits).sum()) > 0 or case == "usable"
    # the same grids threshold to the same map
    same = OCC.OccupancyGrid(hits=torch.tensor(npy(want.hits)),
                             misses=torch.tensor(npy(want.misses)),
                             center=torch.zeros(2), resolution=0.1)
    for occ, free in ((0.65, 0.196), (0.5, 0.3)):
        np.testing.assert_array_equal(
            npy(OCC.threshold(same, occ, free)),
            npy(JOCC.threshold(want, occupied_threshold=occ,
                               free_threshold=free)))


def _cell(x, y, res=0.1, half=64):
    return (int(np.floor(y / res + half)), int(np.floor(x / res + half)))


def test_reference_semantics_hold_on_the_port():
    tri = {c: npy(OCC.threshold(_both(c)[0])) for c in CASES}
    t = tri["single_beam"]
    for x in (0.3, 1.0, 1.7):
        assert t[_cell(x, 0.0)] == OCC.FREE
    assert t[_cell(2.0, 0.0)] == OCC.OCCUPIED
    assert t[_cell(3.0, 0.0)] == OCC.UNKNOWN
    assert t[_cell(3.0 * np.cos(0.3), 3.0 * np.sin(0.3))] == OCC.UNKNOWN
    t = tri["infinity_fill"]
    assert t[_cell(2.0 * np.cos(0.3), 2.0 * np.sin(0.3))] == OCC.FREE
    assert t[_cell(4.0 * np.cos(0.3), 4.0 * np.sin(0.3))] == OCC.UNKNOWN
    assert tri["robot_fill"][_cell(1.0, 1.0)] == OCC.FREE
    assert tri["no_robot_fill"][_cell(1.0, 0.7)] == OCC.UNKNOWN
    assert tri["angle"][_cell(-1.0, 1.0)] == OCC.FREE
    assert tri["angle"][_cell(-1.0, 3.0)] == OCC.OCCUPIED
    h0 = npy(_both("single_beam")[0].hits)
    h1 = npy(_both("square")[0].hits)
    iy, ix = _cell(2.0, 0.0)
    assert (h1[iy - 1:iy + 2, ix - 1:ix + 2] > 0).all()
    assert np.isclose(h1[iy - 1:iy + 2, ix - 1:ix + 2].sum(),
                      9 * h0[iy, ix])
    t = tri["sim"]

    def cell(x, y):
        return (int(np.floor((y - 5.0) / 0.05 + 200)),
                int(np.floor((x - 8.0) / 0.05 + 200)))

    assert t[cell(8.0, 5.0)] == OCC.FREE
    wall = sum(int((t[cell(x, 6.5)[0] - 1:cell(x, 6.5)[0] + 2,
                      cell(x, 6.5)[1] - 1:cell(x, 6.5)[1] + 2]
                    == OCC.OCCUPIED).any())
               for x in np.arange(5.2, 10.8, 0.25))
    assert wall > 15, wall
    assert 0.001 < (t == OCC.OCCUPIED).mean() < 0.2


def test_integrate_in_chunks_changes_nothing(monkeypatch):
    got, _ = _both("sim")
    monkeypatch.setattr(OCC, "CHUNK_SAMPLES", 1)     # one scan at a time
    one, _ = _both("sim")
    np.testing.assert_array_equal(npy(one.hits), npy(got.hits))
    np.testing.assert_array_equal(npy(one.misses), npy(got.misses))


def test_save_pgm_yaml_writes_the_references_bytes(tmp_path):
    rng = np.random.default_rng(0)
    tri = rng.choice(np.asarray([OCC.UNKNOWN, OCC.FREE, OCC.OCCUPIED],
                                np.int8), (64, 64))
    center = np.asarray([3.25, -1.5], np.float32)
    JOCC.save_pgm_yaml(str(tmp_path / "ref"), tri, center, 0.05)
    OCC.save_pgm_yaml(str(tmp_path / "port"), tri, center, 0.05)
    for ext in (".pgm", ".yaml"):
        ref = (tmp_path / f"ref{ext}").read_bytes()
        got = (tmp_path / f"port{ext}").read_bytes()
        if ext == ".yaml":     # the image line names the file
            ref = ref.replace(b"ref.pgm", b"port.pgm")
        assert got == ref
    poses = rng.normal(0, 3, (10, 3))
    np.testing.assert_array_equal(OCC.map_center(poses, 2.0),
                                  JOCC.map_center(poses, 2.0))


def test_map_of_a_saved_graph(tmp_path):
    """``integrate`` takes the port's own ScanSet (a dataclass, not the
    reference's) with its laser offset."""
    poses, scans, center = _inputs("sim")
    scans = dataclasses.replace(scans, laser_offset=jnp.asarray(
        [0.1, 0.0, 0.0], jnp.float32))
    kw = CASES["sim"]
    want = JOCC.integrate(jnp.asarray(poses), scans, jnp.asarray(center),
                          **kw)
    got = OCC.integrate(torch.as_tensor(poses), port(scans, S.ScanSet),
                        torch.as_tensor(center), **kw)
    _assert_counts_close(got.misses, want.misses, 1.0)
    _assert_counts_close(got.hits, want.hits, 3.0)
