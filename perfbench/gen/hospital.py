"""Pools of perturbed pose graphs, made on the host in NumPy from a seed.

A frozen copy of the program's batch function ``sim/graphs.py:
build_merged_batch``, kept here so that the benchmark's inputs cannot move
with the program, and open to any committed snapshot: :func:`snapshot`
tiles one graph (``perfbench/data/<name>.npz``, the ``PoseGraph`` fields)
into a batch, its slots cut to a keyframe bucket, each graph with its own
pose noise on the live, free vertices. It returns a dict of NumPy arrays in
the program's graph layout (a leading batch axis on every field).

For the merged two-robot view the draws are those of the program's
function, in their order, so the same seed gives the same arrays
(``perfbench/tests``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[1] / "data"
VERTEX_FIELDS = ("poses", "vmask", "fixed")
EDGE_FIELDS = ("e_ij", "e_z", "e_info", "emask", "e_level", "e_owner")


def snapshot(batch: int, path: Path, n_slots: int, e_slots: int,
             seed: int = 0, sigma_xy: float = 0.10,
             sigma_th: float = 0.03) -> tuple:
    """``batch`` copies of the graph in ``path`` with pose noise
    ``N(0, sigma_xy)``, ``N(0, sigma_th)`` per graph, in its first
    ``n_slots`` vertex and ``e_slots`` edge slots. Returns ``(graphs,
    meta)``: ``meta`` holds the live counts and, where the snapshot has
    them, ``v_owner`` and ``v_remote`` (each vertex's robot and keyframe
    index)."""
    z = dict(np.load(path))
    rng = np.random.default_rng(seed)
    nv, ne = int(z["n_vertices"]), int(z["n_edges"])
    n, e = int(n_slots), int(e_slots)
    if z["vmask"][n:].any() or z["emask"][e:].any():
        raise ValueError(f"{path.name}: live slots beyond {n} vertices / "
                         f"{e} edges")
    for k in VERTEX_FIELDS:
        z[k] = z[k][:n]
    for k in EDGE_FIELDS:
        z[k] = z[k][:e]
    vmask = z["vmask"]
    noise = np.concatenate(
        [rng.normal(0, sigma_xy, (batch, n, 2)),
         rng.normal(0, sigma_th, (batch, n, 1))], 2).astype(np.float32)
    noise[:, ~vmask] = 0
    noise[:, z["fixed"]] = 0
    poses = (z["poses"][None] + noise).astype(np.float32)

    def bc(a, dtype):
        return np.ascontiguousarray(
            np.broadcast_to(a.astype(dtype), (batch,) + a.shape))

    i32, f32 = np.int32, np.float32
    g = dict(poses=poses, vmask=bc(vmask, bool), fixed=bc(z["fixed"], bool),
             e_ij=bc(z["e_ij"], i32), e_z=bc(z["e_z"], f32),
             e_info=bc(z["e_info"], f32), emask=bc(z["emask"], bool),
             e_level=bc(z["e_level"], i32), e_owner=bc(z["e_owner"], i32),
             n_vertices=np.full(batch, nv, i32),
             n_edges=np.full(batch, ne, i32))
    meta = dict(n_vertices=nv, n_edges=ne)
    if "v_owner" in z:
        meta.update(v_owner=z["v_owner"][:n].astype(i32),
                    v_remote=z["v_remote"][:n].astype(i32),
                    foreign_vertices=int(np.sum(vmask
                                                & (z["v_owner"][:n] != 0))))
    return g, meta
