"""Parity of the port's math core (``utils/se2``, ``core/graph``,
``core/scan``, ``core/linearize``) with ``cg_mrslam_tpu`` on the same
float32 inputs.

Tolerances: ``tests/test_se2.py`` and ``tests/test_linearize.py`` hold
float64 results to 1e-9; both sides here run in float32, so the bar is a
few float32 ulps of the magnitudes involved — atol 1e-5 on poses and
points up to ~10 m (ulp ≈ 1e-6), rtol 1e-5 on chi2 and Jacobians. Integer
and mask fields must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.core import graph as JG
from cg_mrslam_tpu.core import linearize as JL
from cg_mrslam_tpu.core import scan as JS
from cg_mrslam_tpu.utils import se2 as jse2
from cg_mrslam_tpu_torch.core import graph as TG
from cg_mrslam_tpu_torch.core import linearize as TL
from cg_mrslam_tpu_torch.core import scan as TS
from cg_mrslam_tpu_torch.utils import se2 as tse2
from torch_port_helpers import CPU, assert_same_fields, jf, npy, port, tf

torch.set_num_threads(1)

ATOL = 1e-5


def _poses(rng, n):
    return np.concatenate([rng.uniform(-10, 10, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("op", ["compose", "inverse", "relative", "oplus",
                                "apply", "rot", "normalize_angle"])
def test_se2_ops(op):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    args = {
        "compose": (a, b), "inverse": (a,), "relative": (a, b),
        "oplus": (a, b * np.float32(0.3)),
        "apply": (a[:8], rng.uniform(-8, 8, (8, 30, 2)).astype(np.float32)),
        "rot": (a[:, 2],),
        "normalize_angle": (rng.uniform(-12, 12, 64).astype(np.float32),),
    }[op]
    want = getattr(jse2, op)(*(jf(x) for x in args))
    got = getattr(tse2, op)(*(tf(x) for x in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(npy(got), npy(want), atol=ATOL)


def _jax_graph(rng, n=12, e=24, n_edges=15):
    g = JG.empty(n, e, jnp.float32)
    g = dataclasses.replace(
        g, poses=jf(_poses(rng, n) * np.float32(0.5)),
        vmask=jnp.ones((n,), bool), n_vertices=jnp.asarray(n, jnp.int32))
    for k in range(n_edges):
        i, j = int(rng.integers(n)), int(rng.integers(n))
        z = jf(rng.uniform(-1, 1, 3))
        info = jf(np.diag([100.0, 100.0, 1000.0]) + 5.0)
        g = JG.add_edge(g, i, j, z, info, owner=k % 2)
    return g


def test_graph_add_vertex_edge():
    rng = np.random.default_rng(1)
    jg = JG.empty(6, 8, jnp.float32)
    tg = TG.empty(6, 8, CPU)
    assert_same_fields(jg, tg)
    for k in range(4):
        p = rng.uniform(-3, 3, 3).astype(np.float32)
        jg = JG.add_vertex(jg, jf(p), fixed=k == 0)
        tg = TG.add_vertex(tg, tf(p), fixed=k == 0)
    z = rng.uniform(-1, 1, 3).astype(np.float32)
    info = (np.diag([10.0, 20.0, 30.0]) + 1.0).astype(np.float32)
    jg = JG.add_edge(jg, 1, 3, jf(z), jf(info), owner=2)
    tg = TG.add_edge(tg, 1, 3, tf(z), tf(info), owner=2)
    jg = JG.add_edge(jg, 0, 2, jf(z), jf(TG.pack_info(tf(info)).numpy()),
                     index=5)
    tg = TG.add_edge(tg, 0, 2, tf(z), TG.pack_info(tf(info)), index=5)
    assert_same_fields(jg, tg)
    np.testing.assert_array_equal(
        npy(TG.unpack_info(TG.pack_info(tf(info)))), info)


@pytest.mark.parametrize("accept_pattern", ["some", "overflow"])
def test_add_edges_masked_reuses_and_drops(accept_pattern):
    """Free slots are reused lowest first; entries past the free slots
    are dropped (``mode="drop"`` in the reference)."""
    rng = np.random.default_rng(2)
    jg = _jax_graph(rng, n=10, e=12, n_edges=10)
    # free two slots in the middle so reuse and the tail both show
    jg = dataclasses.replace(jg, emask=jg.emask.at[3].set(False)
                             .at[7].set(False))
    tg = port(jg, TG.PoseGraph)
    k = 6
    i = rng.integers(0, 10, k).astype(np.int32)
    j = rng.integers(0, 10, k).astype(np.int32)
    z = rng.uniform(-1, 1, (k, 3)).astype(np.float32)
    info = rng.uniform(1, 5, (k, 6)).astype(np.float32)
    accept = (np.array([1, 0, 1, 1, 0, 1], bool) if accept_pattern == "some"
              else np.ones(k, bool))   # 6 accepted, 4 free slots → 2 drop
    jg2 = JG.add_edges_masked(jg, jf(i), jf(j), jf(z), jf(info),
                              jnp.asarray(accept), owner=3)
    tg2 = TG.add_edges_masked(tg, tf(i), tf(j), tf(z), tf(info),
                              torch.as_tensor(accept), owner=3)
    assert_same_fields(jg2, tg2)


def test_first_k_tie_order():
    """``lax.top_k`` puts the lower index first among equal values."""
    import jax

    score = np.array([3, 7, 7, 1, 7, 3, 0, 7], np.int32)
    want_v, want_i = jax.lax.top_k(jf(score), 6)
    got_v, got_i = TG.first_k(tf(score), 6)
    np.testing.assert_array_equal(npy(got_i), npy(want_i))
    np.testing.assert_array_equal(npy(got_v), npy(want_v))


def test_scan_geometry():
    rng = np.random.default_rng(3)
    beams = 90
    js = JS.empty(5, beams, first_beam_angle=-2.0, angular_step=4.0 / beams,
                  max_range=8.0, usable_range=7.0)
    ts = TS.empty(5, beams, CPU, first_beam_angle=-2.0,
                  angular_step=4.0 / beams, max_range=8.0, usable_range=7.0)
    off = np.array([0.1, -0.05, 0.2], np.float32)
    js = dataclasses.replace(js, laser_offset=jf(off))
    ts = dataclasses.replace(ts, laser_offset=tf(off))
    r = rng.uniform(-0.5, 9.0, (2, beams)).astype(np.float32)
    js = JS.set_scan(JS.set_scan(js, 1, jf(r[0])), 3, jf(r[1]))
    ts = TS.set_scan(TS.set_scan(ts, 1, tf(r[0])), 3, tf(r[1]))
    assert_same_fields(js, ts)
    np.testing.assert_allclose(npy(TS.beam_angles(ts)),
                               npy(JS.beam_angles(js)), atol=1e-6)
    np.testing.assert_array_equal(npy(TS.beam_valid(ts)),
                                  npy(JS.beam_valid(js)))
    np.testing.assert_allclose(npy(TS.scan_points(ts)),
                               npy(JS.scan_points(js)), atol=ATOL)
    idx = np.array([3, 1], np.int32)
    np.testing.assert_allclose(npy(TS.scan_points(ts, tf(idx).long())),
                               npy(JS.scan_points(js, jf(idx))), atol=ATOL)
    pj, vj = JS.points_from_ranges(js, jf(r[1]))
    pt, vt = TS.points_from_ranges(ts, tf(r[1]))
    np.testing.assert_allclose(npy(pt), npy(pj), atol=ATOL)
    np.testing.assert_array_equal(npy(vt), npy(vj))


def test_linearize_and_chi2():
    rng = np.random.default_rng(4)
    jg = _jax_graph(rng)
    tg = port(jg, TG.PoseGraph)
    ej, Jij, Jjj = JL.linearize(jg.poses, jg.e_ij, jg.e_z)
    et, Jit, Jjt = TL.linearize(tg.poses, tg.e_ij, tg.e_z)
    for got, want in ((et, ej), (Jit, Jij), (Jjt, Jjj)):
        np.testing.assert_allclose(npy(got), npy(want), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(npy(TL.edge_errors(tg.poses, tg.e_ij,
                                                  tg.e_z)),
                               npy(JL.edge_errors(jg.poses, jg.e_ij,
                                                  jg.e_z)), atol=ATOL)
    np.testing.assert_allclose(npy(TL.edge_chi2(tg)), npy(JL.edge_chi2(jg)),
                               rtol=1e-5, atol=1e-4)
    half = np.arange(24) % 2 == 0
    for mask in (None, half):
        want = JL.chi2(jg, None if mask is None else jnp.asarray(mask))
        got = TL.chi2(tg, None if mask is None else torch.as_tensor(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
