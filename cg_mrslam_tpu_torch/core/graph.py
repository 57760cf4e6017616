"""Fixed-capacity, mask-based SE(2) pose-graph state.

Port of ``cg_mrslam_tpu/core/graph.py``. A graph is a frozen dataclass of
tensors with static capacity ``N`` vertices / ``E`` edges; updates return a
new graph and never write into the tensors of the one they were given.
Index fields are int32 as in the reference (the state converts between the
packages by value, ``convert.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

LEVEL_DEFAULT = 0


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """One SE(2) pose graph in fixed-capacity tensor form.

    Shapes: poses ``[N,3]``, vmask/fixed ``[N]``, e_ij ``[E,2]``, e_z
    ``[E,3]``, e_info ``[E,6]`` (packed upper-tri, g2o file order ``xx xy
    xt yy yt tt``), emask/e_level/e_owner ``[E]``, n_vertices/n_edges ``[]``.
    """

    poses: torch.Tensor    # [N, 3] float32
    vmask: torch.Tensor    # [N] bool — vertex slot in use
    fixed: torch.Tensor    # [N] bool — gauge-fixed vertex
    e_ij: torch.Tensor     # [E, 2] int32 — endpoint vertex indices
    e_z: torch.Tensor      # [E, 3] float32 — measurement i→j
    e_info: torch.Tensor   # [E, 6] float32 — packed information matrix
    emask: torch.Tensor    # [E] bool — edge slot in use
    e_level: torch.Tensor  # [E] int32 — optimization level / channel
    e_owner: torch.Tensor  # [E] int32 — robot id that created the edge
    n_vertices: torch.Tensor  # [] int32 — number of live vertex slots
    n_edges: torch.Tensor     # [] int32 — number of live edge slots

    @property
    def capacity(self) -> Tuple[int, int]:
        return self.poses.shape[-2], self.e_ij.shape[-2]


def empty(num_vertices: int, num_edges: int, device,
          dtype=torch.float32) -> PoseGraph:
    """An all-masked graph with the given static capacity."""
    z = dict(device=device)
    return PoseGraph(
        poses=torch.zeros((num_vertices, 3), dtype=dtype, **z),
        vmask=torch.zeros((num_vertices,), dtype=torch.bool, **z),
        fixed=torch.zeros((num_vertices,), dtype=torch.bool, **z),
        e_ij=torch.zeros((num_edges, 2), dtype=torch.int32, **z),
        e_z=torch.zeros((num_edges, 3), dtype=dtype, **z),
        e_info=torch.zeros((num_edges, 6), dtype=dtype, **z),
        emask=torch.zeros((num_edges,), dtype=torch.bool, **z),
        e_level=torch.zeros((num_edges,), dtype=torch.int32, **z),
        e_owner=torch.zeros((num_edges,), dtype=torch.int32, **z),
        n_vertices=torch.zeros((), dtype=torch.int32, **z),
        n_edges=torch.zeros((), dtype=torch.int32, **z),
    )


def pack_info(info: torch.Tensor) -> torch.Tensor:
    """``[..., 3, 3]`` symmetric → packed ``[..., 6]`` (xx xy xt yy yt tt)."""
    return torch.stack(
        [info[..., 0, 0], info[..., 0, 1], info[..., 0, 2],
         info[..., 1, 1], info[..., 1, 2], info[..., 2, 2]], dim=-1)


def unpack_info(p: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., 6]`` → full symmetric ``[..., 3, 3]``."""
    xx, xy, xt, yy, yt, tt = (p[..., k] for k in range(6))
    row0 = torch.stack([xx, xy, xt], dim=-1)
    row1 = torch.stack([xy, yy, yt], dim=-1)
    row2 = torch.stack([xt, yt, tt], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


# The step runs with no host synchronization. Two innocent-looking forms
# synchronize on the card: indexing with a 0-dim integer tensor (it is read
# back as a Python int) and assigning a Python scalar into a tensor (a
# host-to-device copy). :func:`row` and :func:`fill` are their sync-free
# forms.


def row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a device scalar index ``i``, without a host sync."""
    return t[i.reshape(1).long()][0]


def fill(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of ``like``'s dtype and device holding ``value``,
    made by a device fill (no host-to-device copy)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _value(t: torch.Tensor, value) -> torch.Tensor:
    """``value`` ready to assign into ``t`` without a host sync."""
    if isinstance(value, torch.Tensor):
        return value.to(device=t.device, dtype=t.dtype)
    return fill(value, t)


def _put(t: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    out = t.clone()
    out[idx.reshape(-1)] = _value(t, value)
    return out


def _as_index(index, g: PoseGraph, default: torch.Tensor) -> torch.Tensor:
    if index is None:
        return default.long()
    return torch.as_tensor(index, device=g.poses.device).long()


def add_vertex(g: PoseGraph, pose: torch.Tensor, fixed=False,
               index=None) -> PoseGraph:
    """Append (or place at ``index``) one vertex; ``index`` defaults to the
    next free slot ``n_vertices`` and may be a device scalar (no host
    sync). The slot must lie inside the capacity."""
    idx = _as_index(index, g, g.n_vertices)
    return dataclasses.replace(
        g,
        poses=_put(g.poses, idx, pose),
        vmask=_put(g.vmask, idx, True),
        fixed=_put(g.fixed, idx, fixed),
        n_vertices=torch.maximum(g.n_vertices, (idx + 1).to(torch.int32)),
    )


def add_edge(g: PoseGraph, i, j, z: torch.Tensor, info: torch.Tensor,
             level=LEVEL_DEFAULT, owner=0, index=None) -> PoseGraph:
    """Append one edge; ``info`` is ``[3,3]`` or packed ``[6]``. ``i``/``j``
    may be device scalars."""
    info = torch.as_tensor(info)
    if info.shape[-1] == 3 and info.ndim >= 2:
        info = pack_info(info)
    idx = _as_index(index, g, g.n_edges)
    dev = g.poses.device
    ij = torch.stack([torch.as_tensor(i, device=dev).reshape(()),
                      torch.as_tensor(j, device=dev).reshape(())])
    return dataclasses.replace(
        g,
        e_ij=_put(g.e_ij, idx, ij),
        e_z=_put(g.e_z, idx, z),
        e_info=_put(g.e_info, idx, info),
        emask=_put(g.emask, idx, True),
        e_level=_put(g.e_level, idx, level),
        e_owner=_put(g.e_owner, idx, owner),
        n_edges=torch.maximum(g.n_edges, (idx + 1).to(torch.int32)),
    )


def first_k(score: torch.Tensor, k: int):
    """``lax.top_k`` with its tie order: the ``k`` largest entries of the
    last axis, and among equal values the lower index first
    (``torch.topk`` promises no tie order; a stable descending sort
    does)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def put_drop(t: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """``t.at[slot].set(value, mode="drop")`` for ``slot`` in ``[0, cap]``:
    slot ``cap`` is routed to a trash row that is cut off again. Callers
    guarantee that only the trash slot repeats."""
    cap = t.shape[0]
    ext = torch.cat([t, t[:1]], dim=0)
    ext[slot] = _value(t, value)
    return ext[:cap]


def add_edges_masked(g: PoseGraph, i: torch.Tensor, j: torch.Tensor,
                     z: torch.Tensor, info: torch.Tensor,
                     accept: torch.Tensor, level=LEVEL_DEFAULT,
                     owner=0) -> PoseGraph:
    """Insert the ``accept``-masked subset of K candidate edges in one
    scatter. Free slots are reused lowest index first; entries that find no
    free slot are dropped (fixed-capacity overflow)."""
    cap = g.e_ij.shape[-2]
    k = accept.shape[0]
    dev = g.poses.device
    free = ~g.emask
    ar = torch.arange(cap, dtype=torch.int32, device=dev)
    score = torch.where(free, -ar, torch.full_like(ar, -2 * cap))
    _, free_slots = first_k(score, min(k, cap))
    order = torch.cumsum(accept.to(torch.int64), 0) - 1
    order = torch.clamp(order, 0, free_slots.shape[0] - 1)
    slot = torch.where(accept, free_slots[order],
                       torch.full_like(order, cap))
    slot = torch.where(free[torch.clamp(slot, 0, cap - 1)], slot,
                       torch.full_like(slot, cap))          # overflow
    placed = slot < cap
    ij = torch.stack([i, j], -1).to(torch.int32)
    return dataclasses.replace(
        g,
        e_ij=put_drop(g.e_ij, slot, ij),
        e_z=put_drop(g.e_z, slot, z),
        e_info=put_drop(g.e_info, slot, info),
        emask=put_drop(g.emask, slot, True),
        e_level=put_drop(g.e_level, slot, level),
        e_owner=put_drop(g.e_owner, slot, owner),
        n_edges=torch.maximum(
            g.n_edges,
            torch.max(torch.where(placed, slot + 1,
                                  torch.zeros_like(slot))).to(torch.int32)),
    )
