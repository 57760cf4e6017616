"""Block cyclic reduction of an SPD block-tridiagonal chain, the
preconditioner the chain and PCG bands share: the reference's
``_cr_factor`` / ``_cr_apply`` / ``_cr_solve`` (``cg_mrslam_tpu/solver/
chain.py``), over ``3·GROUP``-square super-blocks, its factor kept in the
compact form of ``ops/cr_apply.py`` and solved there."""

from __future__ import annotations

import math

import torch

from cg_mrslam_tpu_torch.ops import cr_apply as CA
from cg_mrslam_tpu_torch.solver.spd import _spd_inverse_rec

# Poses per cyclic-reduction super-block (the reference's constant: it
# fixes the factorization's block structure, so the results).
GROUP = 16


def inv3(a: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3×3 inverse (adjugate / det)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    adj = torch.stack([
        torch.stack([c00, c10, c20], -1),
        torch.stack([c01, c11, c21], -1),
        torch.stack([c02, c12, c22], -1),
    ], -2)
    return adj / det[..., None, None]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def inv_block(a: torch.Tensor) -> torch.Tensor:
    """Closed form for 3×3 blocks, the block-Schur recursion for
    super-blocks."""
    if a.shape[-1] == 3:
        return inv3(a)
    return _spd_inverse_rec(a)


def to_super(D: torch.Tensor, L: torch.Tensor, group: int):
    """Regroup a 3×3 block-tridiagonal chain (``D [n, ..., 3, 3]``, the
    batch's axes after the block axis) into dense ``3·group``-square
    super-blocks, padded with uncoupled identity blocks to a power-of-two
    count of super-blocks."""
    n = D.shape[0]
    ns = next_pow2(-(-n // group))
    pad = ns * group - n
    lead = D.shape[1:-2]
    dev = D.device
    if pad:
        eye = torch.eye(3, dtype=D.dtype, device=dev).expand(
            (pad,) + D.shape[1:])
        D = torch.cat([D, eye], dim=0)
        L = torch.cat([L, torch.zeros((pad,) + L.shape[1:], dtype=L.dtype,
                                      device=dev)], dim=0)
        L[n - 1] = 0.0   # padding must not couple
    Dr = D.reshape((ns, group) + D.shape[1:])
    Lr = L.reshape((ns, group) + L.shape[1:])
    b = 3 * group
    Ds = torch.zeros((ns,) + lead + (b, b), dtype=D.dtype, device=dev)
    for k in range(group):
        Ds[..., 3 * k:3 * k + 3, 3 * k:3 * k + 3] = Dr[:, k]
    for k in range(group - 1):
        blk = Lr[:, k]
        Ds[..., 3 * (k + 1):3 * (k + 1) + 3, 3 * k:3 * k + 3] = blk
        Ds[..., 3 * k:3 * k + 3, 3 * (k + 1):3 * (k + 1) + 3] = \
            blk.transpose(-1, -2)
    # L_s[t] = T_s[t+1, t]: only the (first pose of t+1) × (last pose of
    # t) corner is nonzero
    Ls = torch.zeros((ns,) + lead + (b, b), dtype=D.dtype, device=dev)
    Ls[..., 0:3, b - 3:b] = Lr[:, group - 1]
    Ls[ns - 1] = 0.0
    return Ds, Ls


def cr_factor(D: torch.Tensor, L: torch.Tensor, group: int = GROUP):
    """Cyclic-reduction factorization of the SPD block-tridiagonal T
    (``D [n,3,3]``, ``L[k] = T[k+1,k]``; ``[B, n, 3, 3]`` for a batch,
    factored over ``[blocks, B, ...]``) over super-blocks: each level
    eliminates the odd-indexed blocks,

        D'[t] = D[2t] − L[2t−1] D⁻¹[2t−1] Lᵀ[2t−1] − Lᵀ[2t] D⁻¹[2t+1] L[2t]
        L'[t] = −L[2t+1] D⁻¹[2t+1] L[2t]

    and keeps of each level only what the solve reads (``D⁻¹`` and the
    nonzero rows and corners of its couplings, :mod:`ops.cr_apply`):
    returns a :class:`ops.cr_apply.CrFactor`."""
    batched = D.dim() == 4
    if batched:
        D, L = D.movedim(1, 0), L.movedim(1, 0)
    n3 = D.shape[0]
    D, L = to_super(D, L, group)
    m, bb = D.shape[0], D.shape[-1]
    dev = D.device
    eye1 = torch.eye(bb, dtype=D.dtype, device=dev).expand(
        (1,) + D.shape[1:])
    zero1 = torch.zeros((1,) + L.shape[1:], dtype=L.dtype, device=dev)

    b = D.shape[1] if batched else 1
    fact = None
    level = 0
    while D.shape[0] > 1:
        Do = D[1::2]
        Le = L[0::2]                          # L[2t]  : T[2t+1, 2t]
        Lo = L[1::2]                          # L[2t+1]: T[2t+2, 2t+1]
        Doi = inv_block(Do)
        Lprev = torch.cat([zero1, Lo[:-1]], dim=0)          # L[2t−1]
        Doi_prev = torch.cat([eye1, Doi[:-1]], dim=0)
        A = Lprev @ Doi_prev                  # L[2t−1] D⁻¹[2t−1]
        B = Le.transpose(-1, -2) @ Doi        # Lᵀ[2t] D⁻¹[2t+1]
        Dn = D[0::2] - A @ Lprev.transpose(-1, -2) - B @ Le
        # a large batch peaks here: the compact factor is made after the
        # first level's products, and each level's dense blocks are freed
        # once kept
        if fact is None:
            fact = CA.new_factor(b, m, n3, group, batched, Dn)
        CA.pack_level(fact, level, Doi, Le, Lo, A, B)
        del D, Do, Lprev, Doi_prev, A, B
        Ln = -((Lo @ Doi) @ Le)               # T'[2t+2, 2t]
        del L, Le, Lo, Doi
        D, L = Dn, Ln
        level += 1
    if fact is None:                          # one super-block
        fact = CA.new_factor(b, m, n3, group, batched, D)
    CA.pack_root(fact, inv_block(D[0]))
    return fact


def cr_apply_cols(fact: CA.CrFactor, r: torch.Tensor,
                  free: torch.Tensor | None = None) -> torch.Tensor:
    """Solve T z = r for every column of ``r [*C, N, 3]`` (``[B, *C, N,
    3]`` for a batch: the CG state's layout, any strides), the rows of
    vertices not ``free`` (``[N]`` / ``[B, N]``, None: all) zero on read
    and on write. On the card one launch of the kernel
    (:data:`ops.cr_apply.CR_APPLY`), elsewhere its plain version."""
    b = r.shape[0] if fact.batched else 1
    n = r.shape[-2]
    c = math.prod(r.shape[1 if fact.batched else 0:-2])
    r4 = r.reshape(b, c, n, 3)
    f2 = None if free is None else free.reshape(b, n)
    if r.is_cuda:
        z = CA.CR_APPLY(fact, r4, f2)
    else:
        z = CA.cr_apply_plain(fact, r4, f2)
    return z.view(r.shape)


def cr_apply(fact: CA.CrFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs ``[n,3,R]`` (``[B, n, 3, R]`` for a batch; any
    strides) with a :func:`cr_factor` factorization: the columns as
    :func:`cr_apply_cols` takes them, the answer as a view in ``rhs``'s
    shape."""
    return cr_apply_cols(fact, rhs.movedim(-1, -3)).movedim(-3, -1)


def cr_solve(D, L, rhs, group: int = GROUP):
    """One-shot factor + solve."""
    return cr_apply(cr_factor(D, L, group=group), rhs)
