"""Chain + Woodbury Gauss–Newton: the band above ``DENSE_MAX``.

Port of ``cg_mrslam_tpu/solver/chain.py``. A SLAM pose graph is an
odometry chain (edges k→k+1) plus a few loop closures, so its GN Hessian
is block-tridiagonal plus a low-rank term ``H = H_chain + Aᵀ Ω_L A``:

* the λ-damped chain factors by block cyclic reduction over
  ``3·GROUP``-square super-blocks (log₂ levels of batched dense-block
  matmuls);
* the loop edges enter through the Woodbury identity with one
  ``[3M, 3M]`` SPD solve (M = selected loop edges);
* that damped chain+Woodbury inverse preconditions CG on the TRUE
  Hessian, which restores exactness to the CG tolerance.

Merged multi-robot graphs take this path through the (owner,
keyframe-index) slot permutation of :func:`chain_order`. :func:`chainable`
says when the truncated system equals the full one.

Every float sum over edges has one fixed order (bit-identical on repeat):
the chain part through the solve's segment table (``solver/fixed_sum.py``),
the loop part through the one-hot product ``U``, where the reference
scatter-adds.

The CG loops keep the reference's best-iterate tracking and its
breakdown-safe exit selection (:func:`_select_cg_iterate`). Their
tolerance exits run as :func:`solver.spd.masked_loop` (a static budget
with a per-column done mask — the reference's batched ``while_loop``
semantics).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, inverse_permutation,
                                            permute_vertices, unpack_info)
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.solver.fixed_sum import edge_table, segment_sum
from cg_mrslam_tpu_torch.solver.spd import (_spd_inverse_rec, masked_loop,
                                            spd_inverse)
from cg_mrslam_tpu_torch.utils import se2

# Poses per cyclic-reduction super-block (the reference's constant: it
# fixes the factorization's block structure, so the results).
GROUP = 16


def _deg(g: PoseGraph, m: torch.Tensor) -> torch.Tensor:
    """Active-edge degree of every vertex under edge mask ``m``."""
    n = g.poses.shape[0]
    mi = m.to(torch.int32)
    d = torch.zeros((n,), dtype=torch.int32, device=g.poses.device)
    d.index_add_(0, g.e_ij[:, 0].long(), mi)
    d.index_add_(0, g.e_ij[:, 1].long(), mi)
    return d


def chain_masks(g: PoseGraph, edge_mask: torch.Tensor | None = None):
    """Split active edges into chain (j == i+1) and loop parts."""
    mask = g.emask if edge_mask is None else (g.emask & edge_mask)
    is_chain = mask & (g.e_ij[:, 1] == g.e_ij[:, 0] + 1)
    return is_chain, mask & ~is_chain


def chain_order(v_owner: torch.Tensor, v_remote: torch.Tensor,
                vmask: torch.Tensor) -> torch.Tensor:
    """Slot permutation gathering live vertices into (owner,
    keyframe-index) order, under which every robot's odometry chain is
    slot-adjacent. Dead slots share one key and sort to the end in slot
    order (a stable sort, as ``jnp.argsort``)."""
    big = 1 << 20  # v_remote < 2^20 (capacity bound)
    key = torch.where(vmask,
                      v_owner * big + torch.clamp(v_remote, min=0),
                      torch.full_like(v_owner, 0x7FFFFFFF))
    return torch.argsort(key, stable=True).to(torch.int32)


def _select_loops(is_loop: torch.Tensor, loop_cap: int):
    """First ``loop_cap`` active loop edges (ascending slot): ``(sel,
    lmask, loop_used [E], dropped [])``."""
    e = is_loop.shape[0]
    eidx = torch.arange(e, dtype=torch.int32, device=is_loop.device)
    order = torch.where(is_loop, eidx, torch.full_like(eidx, e))
    sel = torch.sort(order).values[:loop_cap]
    lmask = sel < e
    sel = torch.clamp(sel, 0, e - 1)
    loop_used = torch.zeros((e + 1,), dtype=torch.bool,
                            device=is_loop.device)
    loop_used[torch.where(lmask, sel, torch.full_like(sel, e)).long()] = \
        torch.ones((), dtype=torch.bool, device=is_loop.device)
    n_loop = torch.sum(is_loop.to(torch.int32))
    dropped = torch.clamp(n_loop - loop_cap, min=0).to(torch.int32)
    return sel.long(), lmask, loop_used[:e], dropped


def chainable(g: PoseGraph, edge_mask: torch.Tensor | None = None,
              loop_cap: int | None = None,
              order: torch.Tensor | None = None) -> torch.Tensor:
    """True when the fast path is exact against the dense solver: no
    active loop edge beyond ``loop_cap``, and every vertex the dense
    solver would optimize is covered by a chain edge or a selected loop
    edge."""
    if order is not None:
        g = permute_vertices(g, order)
    is_chain, is_loop = chain_masks(g, edge_mask)
    if loop_cap is None:
        loop_used = is_loop
        cap_ok = torch.ones((), dtype=torch.bool, device=g.poses.device)
    else:
        _, _, loop_used, dropped = _select_loops(is_loop, loop_cap)
        cap_ok = dropped == 0
    free_any = g.vmask & ~g.fixed & (_deg(g, is_chain | is_loop) > 0)
    covered = _deg(g, is_chain | loop_used) > 0
    return torch.all(~free_any | covered) & cap_ok


class _Tridiag(NamedTuple):
    D: torch.Tensor      # [N,3,3] λ-damped diagonal blocks (factorized)
    Dt: torch.Tensor     # [N,3,3] true diagonal blocks (CG matvec)
    L: torch.Tensor      # [N,3,3] — L[k] = H[k+1, k]; L[N-1] unused
    free: torch.Tensor   # [N] bool


def _edge_table(g: PoseGraph, edge_mask) -> torch.Tensor:
    """The solve's segment table of the active edges' ends: fixed for a
    solve, so built once (one host read) and passed to every
    :func:`_assemble`."""
    is_chain, is_loop = chain_masks(g, edge_mask)
    return edge_table(g.e_ij, is_chain | is_loop, g.poses.shape[0])


def _assemble(g: PoseGraph, edge_mask, loop_cap: int, damp: float = 1e-3,
              table: torch.Tensor | None = None):
    """One linearization → (tridiagonal chain part, gradient ``b``, loop
    factors ``(li, lj, lJi, lJj, lom, U)``, dropped). Loop edges beyond
    ``loop_cap`` are left out of the whole truncated system. ``table``:
    the solve's :func:`_edge_table` (built here if not given)."""
    n = g.poses.shape[0]
    dt = g.poses.dtype
    dev = g.poses.device
    is_chain, is_loop = chain_masks(g, edge_mask)
    if table is None:
        table = edge_table(g.e_ij, is_chain | is_loop, n)
    e, Ji, Jj = linearize(g.poses, g.e_ij, g.e_z)
    omega = unpack_info(g.e_info)
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()

    sel, lmask, loop_used, dropped = _select_loops(is_loop, loop_cap)

    mask_used = is_chain | loop_used
    free = g.vmask & ~g.fixed & (_deg(g, mask_used) > 0)

    # pinned endpoints contribute identity rows/cols: zero their Jacobian
    Jif = Ji * free[vi].to(dt)[:, None, None]
    Jjf = Jj * free[vj].to(dt)[:, None, None]

    cm = is_chain.to(dt)[:, None, None]
    JiT_O = (Jif.transpose(1, 2) @ omega) * cm
    Hii = JiT_O @ Jif
    Hij = JiT_O @ Jjf
    JjT_O = (Jjf.transpose(1, 2) @ omega) * cm
    Hjj = JjT_O @ Jjf

    D = segment_sum(table, torch.cat([Hii, Hjj]))
    L = segment_sum(table, torch.cat([Hij.transpose(1, 2) * cm,
                                      torch.zeros_like(Hij)]))

    # gradient over the edges IN the truncated system
    om_used = omega * mask_used.to(dt)[:, None, None]
    oe = (om_used @ e[:, :, None])                       # [E,3,1]
    bi = (Jif.transpose(1, 2) @ oe)[:, :, 0]
    bj = (Jjf.transpose(1, 2) @ oe)[:, :, 0]
    b = segment_sum(table, torch.cat([bi, bj]))

    eye = torch.eye(3, dtype=dt, device=dev)
    fb = free[:, None, None]
    diag_scale = torch.sum(D * eye) / torch.clamp(
        3.0 * torch.sum(free.to(dt)), min=1.0)
    lam = damp * diag_scale + 1e-6
    D_true = torch.where(fb, D, eye)
    D = torch.where(fb, D + lam * eye, eye)
    # decouple across pinned vertices
    lok = torch.cat([(free[:n - 1] & free[1:]).to(dt),
                     torch.zeros((1,), dtype=dt, device=dev)])
    L = L * lok[:, None, None]

    lm3 = lmask.to(dt)[:, None, None]
    li = torch.where(lmask, vi[sel], torch.zeros_like(sel))
    lj = torch.where(lmask, vj[sel], torch.zeros_like(sel))
    lJi = Jif[sel] * lm3
    lJj = Jjf[sel] * lm3
    lom = torch.where(lmask[:, None, None], omega[sel], eye)
    # U[3i.., 3m..] = Jᵢ_mᵀ → [N, 3, 3M] (one-hot products: a fixed order)
    m = li.shape[0]
    Oi = torch.nn.functional.one_hot(li, n).to(dt)         # [M,N]
    Oj = torch.nn.functional.one_hot(lj, n).to(dt)
    U = (torch.einsum("mn,mac->ncma", Oi, lJi)
         + torch.einsum("mn,mac->ncma", Oj, lJj)).reshape(n, 3, 3 * m)
    return (_Tridiag(D=D, Dt=D_true, L=L, free=free), b,
            (li, lj, lJi, lJj, lom, U), dropped)


def _inv3(a: torch.Tensor) -> torch.Tensor:
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


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _inv_block(a: torch.Tensor) -> torch.Tensor:
    """Closed form for 3×3 blocks, the block-Schur recursion for
    super-blocks."""
    if a.shape[-1] == 3:
        return _inv3(a)
    return _spd_inverse_rec(a)


def _to_super(D: torch.Tensor, L: torch.Tensor, group: int):
    """Regroup a 3×3 block-tridiagonal chain into dense ``3·group``-square
    super-blocks (tail padded with identity)."""
    n = D.shape[0]
    ns = -(-n // group)
    pad = ns * group - n
    dev = D.device
    if pad:
        eye = torch.eye(3, dtype=D.dtype, device=dev).expand(pad, 3, 3)
        D = torch.cat([D, eye], dim=0)
        L = torch.cat([L, torch.zeros((pad, 3, 3), dtype=L.dtype,
                                      device=dev)], dim=0)
        L[n - 1] = 0.0
    Dr = D.reshape(ns, group, 3, 3)
    Lr = L.reshape(ns, group, 3, 3)
    b = 3 * group
    Ds = torch.zeros((ns, b, b), dtype=D.dtype, device=dev)
    for k in range(group):
        Ds[:, 3 * k:3 * k + 3, 3 * k:3 * k + 3] = Dr[:, k]
    for k in range(group - 1):
        blk = Lr[:, k]
        Ds[:, 3 * (k + 1):3 * (k + 1) + 3, 3 * k:3 * k + 3] = blk
        Ds[:, 3 * k:3 * k + 3, 3 * (k + 1):3 * (k + 1) + 3] = \
            blk.transpose(-1, -2)
    # L_s[t] = T_s[t+1, t]: only the (first pose of t+1) × (last pose of
    # t) corner is nonzero
    Ls = torch.zeros((ns, b, b), dtype=D.dtype, device=dev)
    Ls[:, 0:3, b - 3:b] = Lr[:, group - 1]
    Ls[ns - 1] = 0.0
    return Ds, Ls, ns, pad


def _cr_factor(D: torch.Tensor, L: torch.Tensor, group: int = GROUP):
    """Cyclic-reduction factorization of the SPD block-tridiagonal T
    (``D [n,3,3]``, ``L[k] = T[k+1,k]``) over super-blocks: each level
    eliminates the odd-indexed blocks,

        D'[t] = D[2t] − L[2t−1] D⁻¹[2t−1] Lᵀ[2t−1] − Lᵀ[2t] D⁻¹[2t+1] L[2t]
        L'[t] = −L[2t+1] D⁻¹[2t+1] L[2t]
    """
    n3 = D.shape[0]
    D, L, ns, _ = _to_super(D, L, group)
    bb = D.shape[-1]
    dev = D.device
    n = ns
    m = _next_pow2(n)
    if m > n:
        eye = torch.eye(bb, dtype=D.dtype, device=dev).expand(m - n, bb, bb)
        D = torch.cat([D, eye], dim=0)
        L = torch.cat([L, torch.zeros((m - n, bb, bb), dtype=L.dtype,
                                      device=dev)], dim=0)
        L[n - 1] = 0.0   # padding must not couple
    eye1 = torch.eye(bb, dtype=D.dtype, device=dev)[None]
    zero1 = torch.zeros((1, bb, bb), dtype=L.dtype, device=dev)
    levels = []
    while D.shape[0] > 1:
        Do = D[1::2]
        Le = L[0::2]                          # L[2t]  : T[2t+1, 2t]
        Lo = L[1::2]                          # L[2t+1]: T[2t+2, 2t+1]
        Doi = _inv_block(Do)
        Lprev = torch.cat([zero1, Lo[:-1]], dim=0)          # L[2t−1]
        Doi_prev = torch.cat([eye1, Doi[:-1]], dim=0)
        A = Lprev @ Doi_prev                  # L[2t−1] D⁻¹[2t−1]
        B = Le.transpose(-1, -2) @ Doi        # Lᵀ[2t] D⁻¹[2t+1]
        Dn = D[0::2] - A @ Lprev.transpose(-1, -2) - B @ Le
        Ln = -((Lo @ Doi) @ Le)               # T'[2t+2, 2t]
        levels.append((Doi, Le, Lo, A, B))
        D, L = Dn, Ln
    return {"levels": levels, "root_inv": _inv_block(D[0]),
            "n": n, "m": m, "n3": n3, "group": group}


def _cr_apply(fact, rhs: torch.Tensor) -> torch.Tensor:
    """Solve T x = rhs ``[n,3,R]`` with a :func:`_cr_factor`
    factorization."""
    n, m = fact["n"], fact["m"]
    n3, group = fact["n3"], fact["group"]
    r_cols = rhs.shape[-1]
    dev = rhs.device
    pad3 = n * group - n3
    if pad3:
        rhs = torch.cat([rhs, torch.zeros((pad3,) + rhs.shape[1:],
                                          dtype=rhs.dtype, device=dev)], 0)
    rhs = rhs.reshape(n, 3 * group, r_cols)
    if m > n:
        rhs = torch.cat([rhs, torch.zeros((m - n,) + rhs.shape[1:],
                                          dtype=rhs.dtype, device=dev)], 0)
    pad = torch.nn.functional.pad
    stack = []
    for (Doi, Le, Lo, A, B) in fact["levels"]:
        re, ro = rhs[0::2], rhs[1::2]
        ro_prev = pad(ro[:-1], (0, 0, 0, 0, 1, 0))          # r[2t−1]
        rhs = torch.baddbmm(torch.baddbmm(re, A, ro_prev, alpha=-1.0), B,
                            ro, alpha=-1.0)
        stack.append((Doi, Le, Lo, ro))

    x = fact["root_inv"][None] @ rhs
    for (Doi, Le, Lo, ro) in reversed(stack):
        # x holds this level's even solutions; recover the odds:
        # x[2t+1] = D⁻¹[2t+1] (r[2t+1] − L[2t] x[2t] − Lᵀ[2t+1] x[2t+2])
        x_next = pad(x[1:], (0, 0, 0, 0, 0, 1))
        xo = Doi @ torch.baddbmm(torch.baddbmm(ro, Le, x, alpha=-1.0),
                                 Lo.transpose(-1, -2), x_next, alpha=-1.0)
        k2 = x.shape[0] + xo.shape[0]
        x = torch.stack([x, xo], dim=1).reshape((k2,) + x.shape[1:])
    x = x[:n].reshape(n * group, 3, r_cols)
    return x[:n3]


def _cr_solve(D, L, rhs, group: int = GROUP):
    """One-shot factor + solve."""
    return _cr_apply(_cr_factor(D, L, group=group), rhs)


class _PrecondState(NamedTuple):
    """Chain+Woodbury preconditioner from one linearization: the CR
    factorization of the damped chain, ``Hc⁻¹U`` and ``S⁻¹``."""
    fact: dict
    HinvU: torch.Tensor   # [N, 3, 3M]
    s_inv: torch.Tensor   # [3M, 3M]
    li: torch.Tensor
    lj: torch.Tensor
    lJi: torch.Tensor     # loop Jacobians frozen for the preconditioner
    lJj: torch.Tensor


def _precond_setup(td: _Tridiag, loops) -> _PrecondState:
    """Factor the damped chain and build the Woodbury correction."""
    li, lj, lJi, lJj, lom, U = loops
    m = li.shape[0]

    fact = _cr_factor(td.D, td.L)
    HinvU = _cr_apply(fact, U)                              # [N,3,3M]

    # S = Ω⁻¹ (block-diagonal) + Uᵀ Hc⁻¹ U   [3M, 3M]
    UtX = lJi @ HinvU[li] + lJj @ HinvU[lj]                 # [M,3,3M]
    S4 = UtX.reshape(m, 3, m, 3).clone()
    ar = torch.arange(m, device=li.device)
    S4[ar, :, ar, :] += _inv3(lom)
    s_inv = spd_inverse(S4.reshape(3 * m, 3 * m))
    s_inv = 0.5 * (s_inv + s_inv.T)     # the preconditioner is symmetric
    return _PrecondState(fact=fact, HinvU=HinvU, s_inv=s_inv, li=li, lj=lj,
                         lJi=lJi, lJj=lJj)


def _ut(lJi, lJj, li, lj, x: torch.Tensor) -> torch.Tensor:
    """Uᵀ x for ``x [..., N, 3]`` → ``[..., 3M]`` (U's columns are the
    loop Jacobians' rows). The 3×3 products here and in the matvecs are
    einsums: the blocks are the batch of one product over all of ``x``'s
    leading columns, where a broadcast ``@`` would copy every block once
    per column."""
    y = (torch.einsum("mij,...mj->...mi", lJi, x[..., li, :])
         + torch.einsum("mij,...mj->...mi", lJj, x[..., lj, :]))
    return y.reshape(y.shape[:-2] + (-1,))


def _precond(pst: _PrecondState, r: torch.Tensor) -> torch.Tensor:
    """M r = (Hc+λI + UΩUᵀ)⁻¹ r via Woodbury, for ``r [..., N, 3]``."""
    lead = r.shape[:-2]
    n = r.shape[-2]
    cols = r.reshape(-1, n, 3).permute(1, 2, 0)             # [N,3,C]
    z = _cr_apply(pst.fact, cols).permute(2, 0, 1).reshape(lead + (n, 3))
    y = _ut(pst.lJi, pst.lJj, pst.li, pst.lj, z) @ pst.s_inv.T  # [...,3M]
    return z - torch.einsum("ncq,...q->...nc", pst.HinvU, y)


def _h_matvec(td: _Tridiag, loops, x: torch.Tensor) -> torch.Tensor:
    """TRUE ``H x = (Hc + U Ω Uᵀ) x`` for ``x [..., N, 3]`` — undamped
    diagonal blocks."""
    li, lj, lJi, lJj, lom, U = loops
    D, L = td.Dt, td.L
    xp = torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], -2)
    xn = torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])], -2)
    Lprev = torch.cat([torch.zeros_like(L[:1]), L[:-1]], 0)
    y = (torch.einsum("nij,...nj->...ni", D, x)
         + torch.einsum("nij,...nj->...ni", Lprev, xp)
         + torch.einsum("nji,...nj->...ni", L, xn))
    utx = _ut(lJi, lJj, li, lj, x)
    utx = utx.reshape(utx.shape[:-1] + (-1, 3))             # [...,M,3]
    w = torch.einsum("mij,...mj->...mi", lom, utx)
    return y + torch.einsum("ncq,...q->...nc", U, w.flatten(-2))


def _select_cg_iterate(x_fin, rr2_fin, x_best, rr2_best):
    """The final iterate unless it is clearly worse (>4× in squared
    residual) than the best tracked one; NaN-safe (a non-finite final
    residual counts as breakdown)."""
    broke = ~(rr2_fin <= 4.0 * rr2_best)
    return torch.where(broke[..., None, None], x_best, x_fin)


def _pcg_best(hmv, prec, rhs: torch.Tensor, bn: torch.Tensor, tol2: float,
              budget: int):
    """Preconditioned CG on ``rhs [..., N, 3]`` (leading dims: independent
    systems, each with its own exit) from the warm start ``prec(rhs)``,
    tracking the lowest-residual iterate; exits per system when ``k``
    reaches ``budget`` or ``‖r‖²/bn ≤ tol2``. Returns the selected
    iterate."""
    def dot(a, b):
        return torch.sum(a * b, dim=(-2, -1))

    def col(v):
        return v[..., None, None]

    x = prec(rhs)
    r = rhs - hmv(x)
    z = prec(r)
    rr2 = dot(r, r)
    k0 = torch.zeros(rr2.shape, dtype=torch.int32, device=rhs.device)

    def body(s):
        k, x, rr, p, rz, rr2, x_best, rr2_best = s
        go = (k < budget) & (rr2 / bn > tol2)
        hp = hmv(p)
        den = dot(p, hp)
        ok = den > 1e-30
        alpha = torch.where(ok, rz / torch.where(ok, den,
                                                 torch.ones_like(den)),
                            torch.zeros_like(den))
        x2 = x + col(alpha) * p
        r2 = rr - col(alpha) * hp
        z2 = prec(r2)
        rz2 = dot(r2, z2)
        okb = torch.abs(rz) > 1e-30
        beta = torch.where(okb, rz2 / torch.where(okb, rz,
                                                  torch.ones_like(rz)),
                           torch.zeros_like(rz))
        rr2n = dot(r2, r2)
        better = rr2n < rr2_best
        xb2 = torch.where(col(better), x2, x_best)
        rb2 = torch.where(better, rr2n, rr2_best)
        new = (k + 1, x2, r2, z2 + col(beta) * p, rz2, rr2n, xb2, rb2)
        old = (k, x, rr, p, rz, rr2, x_best, rr2_best)
        return tuple(torch.where(go if a.dim() == go.dim() else col(go),
                                 a, b) for a, b in zip(new, old)), go

    s = masked_loop(body, (k0, x, r, z, dot(r, z), rr2, x, rr2), budget)
    _, x_fin, _, _, _, rr2_fin, x_best, rr2_best = s
    return _select_cg_iterate(x_fin, rr2_fin, x_best, rr2_best)


def _chain_delta_impl(g: PoseGraph, edge_mask, loop_cap: int,
                      cg_tol: float = 1e-6, cg_iters: int = 48,
                      damp: float = 1e-3,
                      table: torch.Tensor | None = None):
    """One GN update via preconditioned CG on the CURRENT true H."""
    td, b, loops, dropped = _assemble(g, edge_mask, loop_cap, damp=damp,
                                      table=table)
    pst = _precond_setup(td, loops)
    bb = -b
    bn = torch.clamp(torch.sum(bb * bb), min=1e-30)
    dx = _pcg_best(lambda x: _h_matvec(td, loops, x),
                   lambda r: _precond(pst, r), bb, bn,
                   cg_tol * cg_tol, cg_iters)
    dx = dx * td.free[:, None].to(dx.dtype)
    return dx, dropped


def chain_delta(g: PoseGraph, edge_mask: torch.Tensor | None = None,
                loop_cap: int = 64, cg_tol: float = 1e-6,
                cg_iters: int = 48, order: torch.Tensor | None = None,
                damp: float = 1e-3):
    """One GN update ``(dx [N,3], dropped)``: CG on the true H,
    preconditioned by the damped chain CR + Woodbury inverse. ``order``
    solves under a slot permutation; ``dx`` is in original slot order."""
    if order is None:
        return _chain_delta_impl(g, edge_mask, loop_cap, cg_tol=cg_tol,
                                 cg_iters=cg_iters, damp=damp)
    inv = inverse_permutation(order).long()
    dx, dropped = _chain_delta_impl(permute_vertices(g, order), edge_mask,
                                    loop_cap, cg_tol=cg_tol,
                                    cg_iters=cg_iters, damp=damp)
    return dx[inv], dropped


def optimize_chain(g: PoseGraph, iterations: int = 5,
                   edge_mask: torch.Tensor | None = None,
                   loop_cap: int = 64, cg_tol: float = 1e-6,
                   cg_iters: int = 48, order: torch.Tensor | None = None,
                   return_dropped: bool = False, damp: float = 1e-3):
    """``optimize(n)`` on the chain+Woodbury path: n GN iterations, oplus
    update. ``order`` solves under a slot permutation (the result is in
    original slot order); ``return_dropped`` adds the largest loop-edge
    overflow count."""
    if order is not None:
        inv = inverse_permutation(order).long()
        gp, dropped = optimize_chain(
            permute_vertices(g, order), iterations, edge_mask, loop_cap,
            cg_tol, cg_iters, return_dropped=True, damp=damp)
        out = dataclasses.replace(g, poses=gp.poses[inv])
        return (out, dropped) if return_dropped else out

    dmax = torch.zeros((), dtype=torch.int32, device=g.poses.device)
    table = _edge_table(g, edge_mask)
    for _ in range(iterations):
        dx, dropped = _chain_delta_impl(g, edge_mask, loop_cap,
                                        cg_tol=cg_tol, cg_iters=cg_iters,
                                        damp=damp, table=table)
        g = dataclasses.replace(g, poses=se2.oplus(g.poses, dx))
        dmax = torch.maximum(dmax, dropped)
    return (g, dmax) if return_dropped else g


def marginal_covariance_chain(g: PoseGraph, query: torch.Tensor,
                              edge_mask: torch.Tensor | None = None,
                              loop_cap: int = 64, cg_tol: float = 1e-5,
                              cg_iters: int = 64,
                              order: torch.Tensor | None = None,
                              damp: float = 1e-3) -> torch.Tensor:
    """Marginal 3×3 covariance blocks ``[Q,3,3]`` of the queried vertices
    on the chain+Woodbury path: each of the 3Q unit columns is a
    preconditioned CG solve on the true H (one linearization, one
    factorization, one Woodbury correction for all), batched over
    columns, each column with its own exit."""
    if order is not None:
        inv = inverse_permutation(order).long()
        return marginal_covariance_chain(
            permute_vertices(g, order), inv[query.long()], edge_mask,
            loop_cap, cg_tol, cg_iters, None, damp)
    n = g.poses.shape[0]
    dt = g.poses.dtype
    dev = g.poses.device
    td, _, loops, _ = _assemble(g, edge_mask, loop_cap, damp=damp)
    pst = _precond_setup(td, loops)
    q = query.shape[0]
    qs = torch.repeat_interleave(query.long(), 3)               # [3Q]
    cs = torch.arange(3, device=dev).repeat(q)                  # [3Q]
    ar = torch.arange(3 * q, device=dev)
    rhs = torch.zeros((3 * q, n, 3), dtype=dt, device=dev)
    rhs[ar, qs, cs] = torch.ones((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    x = _pcg_best(lambda v: _h_matvec(td, loops, v),
                  lambda r: _precond(pst, r), rhs, one, cg_tol * cg_tol,
                  cg_iters)
    cols = x[ar, qs]                                            # [3Q, 3]
    sig = cols.reshape(q, 3, 3).transpose(-1, -2)               # rows × cols
    return 0.5 * (sig + sig.transpose(-1, -2))
