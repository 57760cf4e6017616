"""Sliding-window loop-closure hypothesis buffer + consistency vote.

Port of ``cg_mrslam_tpu/pipeline/closure.py`` (the reference's
``ClosureBuffer`` and ``LoopClosureChecker``): hypotheses ride a
keyframe-age window; each proposes the rigid motion that zeroes its own
error, all are re-scored under it, and the one with most inliers wins.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, add_edges_masked,
                                            first_k, put_drop, row,
                                            unpack_info)
from cg_mrslam_tpu_torch.utils import se2


@dataclasses.dataclass(frozen=True)
class ClosureBuffer:
    """W hypothesis slots. ``v_old`` is the loop vertex, ``v_new`` the
    recent keyframe vertex; ``z`` measures old→new. ``age`` counts
    keyframes since insertion."""

    v_old: torch.Tensor   # [W] int32
    v_new: torch.Tensor   # [W] int32
    z: torch.Tensor       # [W, 3]
    info: torch.Tensor    # [W, 6] packed
    age: torch.Tensor     # [W] int32
    mask: torch.Tensor    # [W] bool


def empty(capacity: int, device) -> ClosureBuffer:
    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ClosureBuffer(
        v_old=z(capacity, dtype=torch.int32),
        v_new=z(capacity, dtype=torch.int32),
        z=z(capacity, 3, dtype=torch.float32),
        info=z(capacity, 6, dtype=torch.float32),
        age=z(capacity, dtype=torch.int32),
        mask=z(capacity, dtype=torch.bool),
    )


def insert(buf: ClosureBuffer, v_old, v_new, z, info,
           valid) -> ClosureBuffer:
    """Write up to K hypotheses ``[K,...]`` (masked by ``valid``) into the
    K best target slots: unused first, then oldest (overwritten when the
    buffer is full). The reference's sequential ``lax.scan`` writes to K
    distinct slots, so it is one masked scatter here: rejected entries go
    to a trash slot past the end."""
    w = buf.mask.shape[0]
    k = valid.shape[0]
    slot_score = torch.where(buf.mask, buf.age.to(torch.float32),
                             torch.full((w,), float(w),
                                        device=buf.mask.device))
    _, slots = first_k(slot_score, k)
    slot = torch.where(valid, slots, torch.full_like(slots, w))

    return ClosureBuffer(
        v_old=put_drop(buf.v_old, slot, v_old),
        v_new=put_drop(buf.v_new, slot, v_new),
        z=put_drop(buf.z, slot, z), info=put_drop(buf.info, slot, info),
        age=put_drop(buf.age, slot, 0), mask=put_drop(buf.mask, slot, True))


def tick(buf: ClosureBuffer, window: int) -> ClosureBuffer:
    """One keyframe passed: ages +1, evict age ≥ window."""
    age = buf.age + buf.mask.to(buf.age.dtype)
    return dataclasses.replace(buf, age=age, mask=buf.mask & (age < window))


class Vote(NamedTuple):
    accept: torch.Tensor     # [W] bool — edges to add to the graph
    n_inliers: torch.Tensor  # [] — inlier count of the best hypothesis
    best: torch.Tensor       # [] — index of the best hypothesis


def consistency_vote(buf: ClosureBuffer, poses: torch.Tensor, *,
                     inlier_threshold: float = 2.0,
                     min_inliers: int = 7) -> Vote:
    """The LoopClosureChecker vote, batched: hypothesis k proposes
    ``T_k = (pose_old_k ∘ z_k) ∘ pose_new_k⁻¹``; every buffered edge m is
    re-scored under T_k, ``chi2[k,m] = eᵀ Ω_m e``. Best k by inlier count,
    ties by total chi2; accepted edges are its inliers when the count
    reaches ``min_inliers``."""
    p_old = poses[buf.v_old.long()]
    p_new = poses[buf.v_new.long()]
    anchor = se2.compose(p_old, buf.z)                       # [W,3]
    T = se2.compose(anchor, se2.inverse(p_new))
    moved = se2.compose(T[:, None, :], p_new[None, :, :])    # [K,W,3]
    err = se2.relative(anchor[None, :, :], moved)            # [K,W,3]
    omega = unpack_info(buf.info)
    c2 = torch.einsum("kwi,wij,kwj->kw", err, omega, err)

    valid = buf.mask
    inlier = valid[None, :] & (c2 < inlier_threshold)
    n_in = torch.sum(inlier, dim=1)
    tot = torch.sum(torch.where(inlier, c2, torch.zeros_like(c2)), dim=1)
    n_in = torch.where(valid, n_in, torch.full_like(n_in, -1))
    score = n_in.to(torch.float32) - tot / (1.0 + torch.max(tot))
    best = torch.argmax(score)
    ok = row(n_in, best) >= min_inliers
    return Vote(accept=row(inlier, best) & ok, n_inliers=row(n_in, best),
                best=best)


def consume(buf: ClosureBuffer, accept: torch.Tensor) -> ClosureBuffer:
    """Drop accepted (now-added) hypotheses from the buffer."""
    return dataclasses.replace(buf, mask=buf.mask & ~accept)


def windowed_vote(buf: ClosureBuffer, poses: torch.Tensor, *, window: int,
                  inlier_threshold, min_inliers):
    """One keyframe's check+update pass with the reference's cadence: the
    vote fires only when the oldest hypothesis reaches age ``window-1``,
    then ages advance and age ≥ window evicts. Returns ``(buffer after
    consume+tick, accept mask, Vote)``."""
    fire = torch.any(buf.mask & (buf.age == window - 1))
    vote = consistency_vote(buf, poses, inlier_threshold=inlier_threshold,
                            min_inliers=min_inliers)
    accept = vote.accept & fire
    out = tick(consume(buf, accept), window)
    return out, accept, vote


def add_accepted(g: PoseGraph, buf: ClosureBuffer, accept: torch.Tensor,
                 owner=0) -> PoseGraph:
    """Scatter all accepted hypothesis edges into the graph in one shot."""
    return add_edges_masked(g, buf.v_old, buf.v_new, buf.z, buf.info,
                            accept, owner=owner)
