"""Batches of pose graphs: the batched-solve workloads.

Ports of the JAX package's batch builders, each drawing the same numpy
random numbers, built on the host and placed on ``device`` (the card
unless the caller names another):

* :func:`build_batch` (``__graft_entry__._build_batch``): ``batch`` graphs
  of a 40-pose square loop (odometry edges and one loop-closing edge,
  information ``diag(100, 100, 1000)``) with the same seeded noise;
* :func:`build_hospital_batch` (``bench.py``): N-pose rings of 40 m radius
  with mid-range loop closures, noise drawn per graph;
* :func:`build_merged_batch` (``bench.py``): the committed two-robot
  merged graph (``tests/fixtures/merged_2robot_1024.npz``, found from the
  package's location), tiled with noise per graph, with its (owner,
  keyframe) order.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.core.graph import PoseGraph

MERGED_FIXTURE = (Path(__file__).resolve().parents[2] / "tests" / "fixtures"
                  / "merged_2robot_1024.npz")
EDGE_FIELDS = ("e_ij", "e_z", "e_info", "emask", "e_level", "e_owner")


def build_batch(batch: int, n_vertices: int = 64, n_edges: int = 128,
                device=None) -> PoseGraph:
    """A batched ``PoseGraph`` ``[batch, ...]`` of noisy square loops."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    T = min(40, n_vertices)

    gt = np.zeros((T, 3))
    for k in range(1, T):
        th = (k // (T // 4)) * np.pi / 2
        gt[k] = gt[k - 1] + [np.cos(th), np.sin(th), 0.0]
        gt[k, 2] = th

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array(
            [c * d[0] + s * d[1], -s * d[0] + c * d[1],
             (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi]
        )

    info = np.array([100.0, 0, 0, 100.0, 0, 1000.0])
    poses = np.zeros((batch, n_vertices, 3), np.float32)
    vmask = np.zeros((batch, n_vertices), bool)
    fixed = np.zeros((batch, n_vertices), bool)
    e_ij = np.zeros((batch, n_edges, 2), np.int32)
    e_z = np.zeros((batch, n_edges, 3), np.float32)
    e_info = np.zeros((batch, n_edges, 6), np.float32)
    emask = np.zeros((batch, n_edges), bool)

    noise = np.concatenate(
        [rng.normal(0, 0.08, (batch, T, 2)),
         rng.normal(0, 0.04, (batch, T, 1))],
        axis=2,
    )
    for b in range(batch):
        noisy = gt + noise[b]
        noisy[0] = gt[0]
        poses[b, :T] = noisy
        vmask[b, :T] = True
        fixed[b, 0] = True
        ne = 0
        for k in range(T - 1):
            e_ij[b, ne] = (k, k + 1)
            e_z[b, ne] = rel(gt[k], gt[k + 1])
            e_info[b, ne] = info
            emask[b, ne] = True
            ne += 1
        e_ij[b, ne] = (T - 1, 0)
        e_z[b, ne] = rel(gt[T - 1], gt[0])
        e_info[b, ne] = info
        emask[b, ne] = True
        ne += 1

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return PoseGraph(
        poses=t(poses), vmask=t(vmask), fixed=t(fixed), e_ij=t(e_ij),
        e_z=t(e_z), e_info=t(e_info), emask=t(emask),
        e_level=torch.zeros((batch, n_edges), dtype=torch.int32, device=dev),
        e_owner=torch.zeros((batch, n_edges), dtype=torch.int32, device=dev),
        n_vertices=torch.full((batch,), T, dtype=torch.int32, device=dev),
        n_edges=torch.full((batch,), ne, dtype=torch.int32, device=dev))


def hospital_truth(n: int = 1024) -> np.ndarray:
    """The true poses ``[n, 3]`` (float64) of :func:`build_hospital_batch`'s
    ring. Its measurements are exact and vertex 0 is fixed at its true
    pose, so these poses are every graph's optimum (chi2 0)."""
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([40 * np.cos(th), 40 * np.sin(th), th + np.pi / 2], 1)


def build_hospital_batch(batch: int, n: int = 1024, closures: int = 48,
                         seed: int = 0, device=None) -> PoseGraph:
    """A batch of single-robot hospital-scale graphs: an N-pose ring of
    40 m radius (0.25 m keyframe spacing at the default N) with
    ``closures`` mid-range loop closures shared by the batch, each graph
    with its own pose noise (``bench.py``'s draws, in its order)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    gt = hospital_truth(n)

    def rel(a, b):
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        d = b[:, :2] - a[:, :2]
        return np.stack(
            [c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
             (b[:, 2] - a[:, 2] + np.pi) % (2 * np.pi) - np.pi], 1)

    e = n - 1 + closures
    info = np.array([100.0, 0, 0, 100.0, 0, 1000.0], np.float32)
    ci = rng.integers(0, n - 1, closures)
    cj = (ci + n // 2) % n
    lo, hi = np.minimum(ci, cj), np.maximum(ci, cj)
    e_ij = np.concatenate([
        np.stack([np.arange(n - 1), np.arange(1, n)], 1),
        np.stack([lo, hi], 1)]).astype(np.int32)
    e_z = np.concatenate([rel(gt[:-1], gt[1:]), rel(gt[lo], gt[hi])]
                         ).astype(np.float32)
    noise = np.concatenate(
        [rng.normal(0, 0.15, (batch, n, 2)),
         rng.normal(0, 0.04, (batch, n, 1))], 2).astype(np.float32)
    noise[:, 0] = 0
    poses = (gt[None] + noise).astype(np.float32)
    fixed = np.zeros((batch, n), bool)
    fixed[:, 0] = True

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    def bc(a):
        return t(np.broadcast_to(a, (batch,) + a.shape))

    return PoseGraph(
        poses=t(poses), vmask=torch.ones((batch, n), dtype=torch.bool,
                                         device=dev),
        fixed=t(fixed), e_ij=bc(e_ij), e_z=bc(e_z),
        e_info=bc(np.broadcast_to(info, (e, 6)).astype(np.float32)),
        emask=torch.ones((batch, e), dtype=torch.bool, device=dev),
        e_level=torch.zeros((batch, e), dtype=torch.int32, device=dev),
        e_owner=torch.zeros((batch, e), dtype=torch.int32, device=dev),
        n_vertices=torch.full((batch,), n, dtype=torch.int32, device=dev),
        n_edges=torch.full((batch,), e, dtype=torch.int32, device=dev))


def build_merged_batch(batch: int, seed: int = 0, device=None):
    """The two-robot merged workload: the committed protocol snapshot
    (robot 0's merged view from a ``MultiRobotSim`` run), tiled to
    ``batch`` with pose noise per graph (``bench.py``'s draws). Its edge
    capacity is cut to the live edges rounded up to 128. Returns
    ``(graphs, order, meta)``: ``order`` the (owner, keyframe) slot
    permutation of :func:`solver.chain.chain_order`."""
    from cg_mrslam_tpu_torch.solver.chain import chain_order

    dev = resolve_device(device)
    z = dict(np.load(MERGED_FIXTURE))
    rng = np.random.default_rng(seed)
    e_cap = int(-(-int(z["n_edges"]) // 128) * 128)
    for k in EDGE_FIELDS:
        z[k] = z[k][:e_cap]
    poses0 = z["poses"]
    vmask = z["vmask"]
    n = poses0.shape[0]
    noise = np.concatenate(
        [rng.normal(0, 0.10, (batch, n, 2)),
         rng.normal(0, 0.03, (batch, n, 1))], 2).astype(np.float32)
    noise[:, ~vmask] = 0
    noise[:, z["fixed"]] = 0
    poses = (poses0[None] + noise).astype(np.float32)

    def bc(a, dtype=None):
        a = np.array(np.broadcast_to(a, (batch,) + a.shape))
        return torch.as_tensor(a if dtype is None else a.astype(dtype),
                               device=dev)

    i32, f32 = np.int32, np.float32
    g = PoseGraph(
        poses=torch.as_tensor(poses, device=dev), vmask=bc(vmask),
        fixed=bc(z["fixed"]), e_ij=bc(z["e_ij"], i32),
        e_z=bc(z["e_z"], f32), e_info=bc(z["e_info"], f32),
        emask=bc(z["emask"]), e_level=bc(z["e_level"], i32),
        e_owner=bc(z["e_owner"], i32),
        n_vertices=torch.full((batch,), int(z["n_vertices"]),
                              dtype=torch.int32, device=dev),
        n_edges=torch.full((batch,), int(z["n_edges"]), dtype=torch.int32,
                           device=dev))
    order = chain_order(torch.as_tensor(z["v_owner"].astype(i32), device=dev),
                        torch.as_tensor(z["v_remote"].astype(i32),
                                        device=dev),
                        torch.as_tensor(vmask, device=dev))
    meta = {"n_vertices": int(z["n_vertices"]),
            "n_edges": int(z["n_edges"]),
            "foreign_vertices": int(np.sum(vmask & (z["v_owner"] != 0)))}
    return g, order, meta
