"""Batches of noisy square-loop pose graphs (the batched-solve workload).

Port of ``__graft_entry__._build_batch``: ``batch`` graphs of a 40-pose
square loop (odometry edges and one loop-closing edge, information
``diag(100, 100, 1000)``) with the same seeded noise on the poses, built on
the host in numpy and placed on ``device`` (the card unless the caller
names another).
"""

from __future__ import annotations

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.core.graph import PoseGraph


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
