"""Parity of the port's IO (``io/g2o.py`` with its native parser,
``io/carmen.py``, ``core/scan.resample_scan_np``) with ``cg_mrslam_tpu``, on
the same numpy inputs.

Bars and why:

* ``g2o.save`` of the same graph writes the same bytes in both packages
  (both format float64 copies of the same float32 values);
* both of the port's parsers load what the reference's loader loads: equal
  ids, masks, edge endpoints, provenance and scan geometry, and float32
  values equal to the reference's (both round the same text to float32);
* a malformed file, or a native build from a broken source, raises;
* CARMEN and the resample are numpy in both packages: equal arrays, and the
  reference test's own assertions hold on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core import graph as JG
from cg_mrslam_tpu.core import scan as JS
from cg_mrslam_tpu.io import carmen as JC
from cg_mrslam_tpu.io import g2o as JIO
from cg_mrslam_tpu.sim import world as JW
from cg_mrslam_tpu_torch import native as N
from cg_mrslam_tpu_torch.core import graph as G
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.io import carmen as TC
from cg_mrslam_tpu_torch.io import g2o as TIO

from torch_port_helpers import CPU, jf, npy, port

torch.set_num_threads(1)

FOV = 2 * np.pi * 0.75


def _graph(seed=0, n=40, cap_v=48, cap_e=96, beams=24):
    """A reference graph + scans: a chain with closures, namespaced ids
    (two owners), one fixed vertex, a dead vertex slot, edges with owner
    and level provenance, scans on most vertices and a laser offset."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((cap_v, 3), np.float32)
    poses[:n] = rng.normal(0, 4, (n, 3)) * [1, 1, 0.5]
    vmask = np.arange(cap_v) < n
    vmask[7] = False
    fixed = np.zeros(cap_v, bool)
    fixed[0] = True
    pairs = [(k, k + 1) for k in range(n - 1) if 7 not in (k, k + 1)]
    pairs += [(3, 20), (5, 33), (12, 39), (20, 3)]
    e = len(pairs)
    e_ij = np.zeros((cap_e, 2), np.int32)
    e_ij[:e] = pairs
    e_z = np.zeros((cap_e, 3), np.float32)
    e_z[:e] = rng.normal(0, 1, (e, 3))
    info = rng.uniform(1, 500, (cap_e, 6)).astype(np.float32)
    emask = np.arange(cap_e) < e
    e_owner = np.zeros(cap_e, np.int32)
    e_level = np.zeros(cap_e, np.int32)
    e_owner[[2, 9, e - 1]] = [1, 1, 2]
    e_level[[9, e - 2]] = [2, 1]
    g = JG.PoseGraph(
        poses=jf(poses), vmask=jf(vmask), fixed=jf(fixed), e_ij=jf(e_ij),
        e_z=jf(e_z), e_info=jf(info), emask=jf(emask), e_level=jf(e_level),
        e_owner=jf(e_owner), n_vertices=jf(np.int32(n)),
        n_edges=jf(np.int32(e)))
    scans = JS.empty(cap_v, beams, first_beam_angle=-FOV / 2,
                     angular_step=FOV / beams, max_range=8.0)
    ranges = rng.uniform(0.3, 8.0, (cap_v, beams)).astype(np.float32)
    ranges[:, ::5] = 8.0
    smask = vmask.copy()
    smask[[4, 11]] = False
    scans = dataclasses.replace(
        scans, ranges=jf(ranges), smask=jf(smask),
        laser_offset=jf(np.asarray([0.08, -0.02, 0.01], np.float32)))
    owner = np.arange(cap_v) % 3 == 1
    ids = np.arange(cap_v, dtype=np.int64) + 10000 * owner
    return g, scans, ids


def test_save_writes_the_references_bytes(tmp_path):
    g, scans, ids = _graph()
    JIO.save(str(tmp_path / "ref.g2o"), g, ids=ids, scans=scans)
    TIO.save(str(tmp_path / "port.g2o"), port(g, G.PoseGraph), ids=ids,
             scans=port(scans, S.ScanSet))
    ref = (tmp_path / "ref.g2o").read_bytes()
    assert (tmp_path / "port.g2o").read_bytes() == ref
    assert b"CGM_EDGE_META" in ref and b"ROBOTLASER1" in ref
    # no ids, no scans
    JIO.save(str(tmp_path / "ref2.g2o"), g)
    TIO.save(str(tmp_path / "port2.g2o"), port(g, G.PoseGraph))
    assert (tmp_path / "port2.g2o").read_bytes() == \
        (tmp_path / "ref2.g2o").read_bytes()


def _write_sample(path, n=120):
    """An external-style file (test_native_g2o.py's shape): sparse ids, a
    comment, FIX before the edges, scans on every other vertex."""
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        f.write("# written by another tool\n")
        for k in range(n):
            x, y, th = rng.normal(0, 5, 3)
            f.write(f"VERTEX_SE2 {3 * k + 7} {x:.6f} {y:.6f} {th:.6f}\n")
            if k % 2 == 0:
                rs = " ".join(f"{r:.3f}" for r in rng.uniform(0.5, 8, 16))
                f.write(
                    f"ROBOTLASER1 0 -1.5708 3.1416 0.19635 8.00 0.01 0 16 "
                    f"{rs} 0 {x:.4f} {y:.4f} {th:.4f} {x - 0.1:.4f} "
                    f"{y:.4f} {th:.4f} 0 0 0 0 0 0 host 0\n")
        f.write("FIX 7 10\n")
        for k in range(n - 1):
            z = rng.normal(0, 1, 3)
            f.write(f"EDGE_SE2 {3 * k + 7} {3 * k + 10} {z[0]:.6f} "
                    f"{z[1]:.6f} {z[2]:.6f} 100 0 0 100 0 1000\n")


def _assert_loaded_equal(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.has_edge_meta == want.has_edge_meta
    gg, wg = got.graph, want.graph
    for name in ("vmask", "fixed", "e_ij", "emask", "e_owner", "e_level",
                 "n_vertices", "n_edges"):
        np.testing.assert_array_equal(npy(getattr(gg, name)).astype(np.int64),
                                      npy(getattr(wg, name)).astype(np.int64),
                                      err_msg=name)
    for name in ("poses", "e_z", "e_info"):
        np.testing.assert_array_equal(
            npy(getattr(gg, name)),
            npy(getattr(wg, name)).astype(np.float32), err_msg=name)
    assert (got.scans is None) == (want.scans is None)
    if want.scans is not None:
        np.testing.assert_array_equal(npy(got.scans.smask),
                                      npy(want.scans.smask))
        np.testing.assert_array_equal(npy(got.scans.ranges),
                                      npy(want.scans.ranges))
        for name in ("first_beam_angle", "angular_step", "max_range",
                     "usable_range"):
            np.testing.assert_allclose(
                float(getattr(got.scans, name)),
                float(getattr(want.scans, name)), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(npy(got.scans.laser_offset),
                                   npy(want.scans.laser_offset), atol=1e-6)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["saved", "external"])
def test_load_matches_the_reference(tmp_path, native, kind):
    path = str(tmp_path / "g.g2o")
    if kind == "saved":
        g, scans, ids = _graph(seed=3)
        JIO.save(path, g, ids=ids, scans=scans)
        caps = dict(max_vertices=64, max_edges=128)
    else:
        _write_sample(path)
        caps = {}
    want = JIO.load(path, native=False, **caps)
    got = TIO.load(path, native=native, device="cpu", **caps)
    assert got.graph.poses.device == CPU
    _assert_loaded_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
def test_malformed_file_raises(tmp_path, native):
    path = tmp_path / "bad.g2o"
    path.write_text("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1.0 zero 0\n"
                    "EDGE_SE2 0 1 1 0 0 1 0 0 1 0 1\n")
    with pytest.raises(ValueError):
        TIO.load(str(path), native=native, device="cpu")
    path.write_text("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\n"
                    "EDGE_SE2 0 1 1 0 0 1 0 0 1 0\n")   # one field short
    with pytest.raises(ValueError):
        TIO.load(str(path), native=native, device="cpu")


def test_native_build_of_a_broken_source_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int g2o_count( { return 0; }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.build(src)
    with pytest.raises(OSError):
        N.parse_g2o(str(tmp_path / "missing.g2o"))


def test_native_library_builds_under_the_repository(tmp_path):
    lib = N.build()
    assert lib.parent == N.BUILD_DIR
    assert N.BUILD_DIR.parts[-2:] == ("build", "native")
    assert N.BUILD_DIR.parent.parent == N.SRC.parents[2]


def test_resample_scan_matches_the_reference():
    rng = np.random.default_rng(4)
    rows = rng.uniform(0.2, 8.0, (5, 91)).astype(np.float32)
    rows[:, ::7] = 8.0
    rows[:, 3] = 0.0
    for args in [(-np.pi / 2, np.pi / 90, 8.0, 181, -np.pi / 2,
                  np.pi / 180, 6.0),
                 (-1.0, 0.02, 8.0, 64, -1.2, 0.04, 8.0)]:
        np.testing.assert_array_equal(S.resample_scan_np(rows, *args),
                                      JS.resample_scan_np(rows, *args))
        np.testing.assert_array_equal(S.resample_scan_np(rows[0], *args),
                                      JS.resample_scan_np(rows[0], *args))


# --- CARMEN: the reference's cases (tests/test_carmen.py) on both packages


def _assert_logs_equal(a, b):
    for name in ("odom", "laser_pose", "ranges", "timestamps"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    for name in ("fov", "start_angle", "angular_step", "max_range"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.rel_odom(), b.rel_odom())
    np.testing.assert_array_equal(a.laser_offset(), b.laser_offset())


def test_carmen_roundtrip_robotlaser1(tmp_path):
    beams, T = 90, 60
    traj = JW.simulate_robot(
        JW.hospital_world(16.0, 10.0, seed=3),
        JW.corridor_waypoints(16.0, 10.0, 0, 1), seed=4, beams=beams,
        fov=FOV, max_range=8.0, odom_noise=(0.01, 0.004))
    paths = {}
    for name, mod in (("ref", JC), ("port", TC)):
        paths[name] = str(tmp_path / f"{name}.clf")
        mod.write(paths[name], traj.odom[:T], traj.ranges[:T], fov=FOV,
                  max_range=8.0, start_angle=-FOV / 2,
                  angular_step=FOV / beams)
    body = [open(p).read().split("\n", 1)[1] for p in paths.values()]
    assert body[0] == body[1]          # the same records
    log = TC.read(paths["port"])
    _assert_logs_equal(log, JC.read(paths["port"]))
    assert log.ranges.shape == (T, beams)
    np.testing.assert_allclose(log.odom, traj.odom[:T], atol=1e-5)
    np.testing.assert_allclose(log.ranges, traj.ranges[:T], atol=2e-3)
    assert abs(log.start_angle + FOV / 2) < 1e-6
    assert abs(log.angular_step - FOV / beams) < 1e-9


def test_carmen_flaser_and_resample(tmp_path):
    lines = ["# comment\n", "PARAM robot_frontlaser_offset 0.08\n"]
    for t in range(3):
        r = " ".join(["2.0"] * 181)
        lines.append(f"FLASER 181 {r} {0.1*t:.3f} 0.0 0.0 {0.1*t:.3f} 0.0 "
                     f"0.0 {100.0+t:.3f} host {100.0+t:.3f}\n")
    n = 91
    r = ["2.000"] * n
    r[40] = "81.900"                   # SICK no-return
    path = tmp_path / "intel.clf"
    path.write_text("".join(lines))
    log = TC.read(str(path), beams=64, max_range=5.0)
    _assert_logs_equal(log, JC.read(str(path), beams=64, max_range=5.0))
    assert np.all(log.ranges == 2.0)
    assert abs(log.angular_step * 63 - np.pi) < 1e-6
    # invalid returns do not blend into their neighbours
    path2 = tmp_path / "d.clf"
    path2.write_text(f"FLASER {n} {' '.join(r)} 0 0 0 0 0 0 100.0 h 100.0\n")
    log = TC.read(str(path2), beams=181, max_range=8.0)
    _assert_logs_equal(log, JC.read(str(path2), beams=181, max_range=8.0))
    src_a = -np.pi / 2 + (np.pi / (n - 1)) * 40
    dst_a = log.start_angle + log.angular_step * np.arange(181)
    snapped = np.abs(dst_a - src_a) <= np.pi / (n - 1)
    assert snapped.any() and (log.ranges[0][snapped] >= 8.0 - 1e-4).all()


def test_carmen_mixed_beams_and_laser_offset(tmp_path):
    path = tmp_path / "mixed.clf"
    path.write_text(
        f"FLASER 181 {' '.join(['3.0'] * 181)} 0 0 0 0 0 0 1.0 h 1.0\n"
        f"FLASER 361 {' '.join(['4.0'] * 361)} 0 0 0 0 0 0 2.0 h 2.0\n")
    log = TC.read(str(path), beams=91, max_range=8.0)
    _assert_logs_equal(log, JC.read(str(path), beams=91, max_range=8.0))
    np.testing.assert_allclose(log.ranges[1], 4.0, atol=1e-4)
    T, B = 5, 45
    rng = np.random.default_rng(0)
    odom = np.cumsum(rng.normal(0, 0.1, (T, 3)), axis=0)
    lp = odom.copy()
    lp[:, 0] += 0.08 * np.cos(odom[:, 2])
    lp[:, 1] += 0.08 * np.sin(odom[:, 2])
    off = str(tmp_path / "off.clf")
    TC.write(off, odom, np.full((T, B), 3.0, np.float32), fov=np.pi,
             max_range=8.0, laser_pose=lp)
    log = TC.read(off)
    _assert_logs_equal(log, JC.read(off))
    np.testing.assert_allclose(log.laser_offset(), [0.08, 0.0, 0.0],
                               atol=1e-5)
