"""Chain + Woodbury Gauss–Newton: the band above ``DENSE_MAX``.

Port of ``cg_mrslam_tpu/solver/chain.py``. A SLAM pose graph is an
odometry chain (edges k→k+1) plus a few loop closures, so its GN Hessian
is block-tridiagonal plus a low-rank term ``H = H_chain + Aᵀ Ω_L A``:

* the λ-damped chain factors by block cyclic reduction
  (``solver/cyclic_reduction.py``, shared with the PCG band: compact, and
  solved on the card by one kernel);
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

:func:`optimize_chain` keeps the reference's two levers: ``cg_schedule``
(one CG budget per GN iteration) and ``freeze_precond`` (one
preconditioner for every iteration, each iteration checked by
:func:`_freeze_diverged` and redone with a fresh one where chi2 rose).

**Batches of graphs.** Every entry point also takes a graph with a leading
batch axis (``[B, N, ...]``; the reference ``vmap``s over it) and one
``order`` for every graph. The batch shares one segment table (one host
read), the cyclic reduction runs over ``[blocks, B, ...]``, and every CG
system keeps its own exit, so a graph's result does not depend on its
batch-mates. Batch-1 calls keep their own operations and bits.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, degrees,
                                            inverse_permutation,
                                            permute_vertices, unpack_info)
from cg_mrslam_tpu_torch.core.linearize import chi2, linearize
from cg_mrslam_tpu_torch.ops import cr_apply as CA
from cg_mrslam_tpu_torch.solver.cyclic_reduction import (cr_apply,
                                                         cr_apply_cols,
                                                         cr_factor, inv3)
from cg_mrslam_tpu_torch.solver.fixed_sum import edge_table, ends_sum
from cg_mrslam_tpu_torch.solver.gather import (marginal_blocks, pick,
                                               rows_of, unit_columns)
from cg_mrslam_tpu_torch.solver.spd import masked_loop, per, spd_inverse
from cg_mrslam_tpu_torch.utils import se2
from cg_mrslam_tpu_torch.utils.metrics import count, span

# Graphs whose frozen-preconditioner GN iteration :func:`_freeze_diverged`
# sent back to be redone with a fresh preconditioner. A plain counter for
# runs that report it; nothing reads it on the solve path.
FREEZE_REDOS = collections.Counter()


def _deg(g: PoseGraph, m: torch.Tensor) -> torch.Tensor:
    """Active-edge degree of every vertex under edge mask ``m``."""
    return degrees(g.e_ij, m, g.poses.shape[-2])


def _bspec(spec: str) -> str:
    """An einsum spec with a leading batch index ``b`` on every operand."""
    ins, out = spec.split("->")
    return ",".join("b" + t for t in ins.split(",")) + "->b" + out


def _es(spec: str, *ops, batched: bool = False) -> torch.Tensor:
    return torch.einsum(_bspec(spec) if batched else spec, *ops)


def chain_masks(g: PoseGraph, edge_mask: torch.Tensor | None = None):
    """Split active edges into chain (j == i+1) and loop parts."""
    mask = g.emask if edge_mask is None else (g.emask & edge_mask)
    is_chain = mask & (g.e_ij[..., 1] == g.e_ij[..., 0] + 1)
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
    lmask, loop_used [E], dropped [])``, each with the batch's leading
    axis for a batch."""
    e = is_loop.shape[-1]
    eidx = torch.arange(e, dtype=torch.int32, device=is_loop.device)
    order = torch.where(is_loop, eidx, torch.full_like(eidx, e))
    sel = torch.sort(order).values[..., :loop_cap]
    lmask = sel < e
    sel = torch.clamp(sel, 0, e - 1)
    loop_used = torch.zeros(is_loop.shape[:-1] + (e + 1,), dtype=torch.bool,
                            device=is_loop.device)
    loop_used.scatter_(-1, torch.where(lmask, sel,
                                       torch.full_like(sel, e)).long(),
                       torch.ones_like(lmask))
    n_loop = torch.sum(is_loop.to(torch.int32), dim=-1)
    dropped = torch.clamp(n_loop - loop_cap, min=0).to(torch.int32)
    return sel.long(), lmask, loop_used[..., :e], dropped


def chainable(g: PoseGraph, edge_mask: torch.Tensor | None = None,
              loop_cap: int | None = None,
              order: torch.Tensor | None = None) -> torch.Tensor:
    """True when the fast path is exact against the dense solver: no
    active loop edge beyond ``loop_cap``, and every vertex the dense
    solver would optimize is covered by a chain edge or a selected loop
    edge (``[B]`` for a batch)."""
    if order is not None:
        g = permute_vertices(g, order)
    is_chain, is_loop = chain_masks(g, edge_mask)
    if loop_cap is None:
        loop_used = is_loop
        cap_ok = torch.ones(g.poses.shape[:-2], dtype=torch.bool,
                            device=g.poses.device)
    else:
        _, _, loop_used, dropped = _select_loops(is_loop, loop_cap)
        cap_ok = dropped == 0
    free_any = g.vmask & ~g.fixed & (_deg(g, is_chain | is_loop) > 0)
    covered = _deg(g, is_chain | loop_used) > 0
    return torch.all(~free_any | covered, dim=-1) & cap_ok


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
    return edge_table(g.e_ij, is_chain | is_loop, g.poses.shape[-2]).table


def _assemble(g: PoseGraph, edge_mask, loop_cap: int, damp: float = 1e-3,
              table: torch.Tensor | None = None):
    """One linearization → (tridiagonal chain part, gradient ``b``, loop
    factors ``(li, lj, lJi, lJj, lom, U)``, dropped). Loop edges beyond
    ``loop_cap`` are left out of the whole truncated system. ``table``:
    the solve's :func:`_edge_table` (built here if not given)."""
    bat = g.poses.dim() == 3
    n = g.poses.shape[-2]
    dt = g.poses.dtype
    dev = g.poses.device
    is_chain, is_loop = chain_masks(g, edge_mask)
    if table is None:
        table = edge_table(g.e_ij, is_chain | is_loop, n).table
    e, Ji, Jj = linearize(g.poses, g.e_ij, g.e_z)
    omega = unpack_info(g.e_info)
    vi, vj = g.e_ij[..., 0].long(), g.e_ij[..., 1].long()

    def ends(at_i, at_j):
        return ends_sum(table, at_i, at_j, g.poses.dim() - 2)

    sel, lmask, loop_used, dropped = _select_loops(is_loop, loop_cap)

    mask_used = is_chain | loop_used
    free = g.vmask & ~g.fixed & (_deg(g, mask_used) > 0)

    # pinned endpoints contribute identity rows/cols: zero their Jacobian
    Jif = Ji * free.gather(-1, vi).to(dt)[..., None, None]
    Jjf = Jj * free.gather(-1, vj).to(dt)[..., None, None]

    cm = is_chain.to(dt)[..., None, None]
    JiT_O = (Jif.transpose(-1, -2) @ omega) * cm
    Hii = JiT_O @ Jif
    Hij = JiT_O @ Jjf
    JjT_O = (Jjf.transpose(-1, -2) @ omega) * cm
    Hjj = JjT_O @ Jjf

    D = ends(Hii, Hjj)
    L = ends(Hij.transpose(-1, -2) * cm, torch.zeros_like(Hij))

    # gradient over the edges IN the truncated system
    om_used = omega * mask_used.to(dt)[..., None, None]
    oe = (om_used @ e[..., None])                        # [E,3,1]
    bi = (Jif.transpose(-1, -2) @ oe)[..., 0]
    bj = (Jjf.transpose(-1, -2) @ oe)[..., 0]
    b = ends(bi, bj)

    eye = torch.eye(3, dtype=dt, device=dev)
    fb = free[..., None, None]
    diag_scale = torch.sum(D * eye, dim=(-3, -2, -1)) / torch.clamp(
        3.0 * torch.sum(free.to(dt), dim=-1), min=1.0)
    lam = per(damp * diag_scale + 1e-6, D)
    D_true = torch.where(fb, D, eye)
    D = torch.where(fb, D + lam * eye, eye)
    # decouple across pinned vertices
    lok = torch.cat([(free[..., :n - 1] & free[..., 1:]).to(dt),
                     torch.zeros(free.shape[:-1] + (1,), dtype=dt,
                                 device=dev)], -1)
    L = L * lok[..., None, None]

    lm3 = lmask.to(dt)[..., None, None]
    li = torch.where(lmask, vi.gather(-1, sel), torch.zeros_like(sel))
    lj = torch.where(lmask, vj.gather(-1, sel), torch.zeros_like(sel))
    lJi = pick(Jif, sel) * lm3
    lJj = pick(Jjf, sel) * lm3
    lom = torch.where(lmask[..., None, None], pick(omega, sel), eye)
    # U[3i.., 3m..] = Jᵢ_mᵀ → [N, 3, 3M] (one-hot products: a fixed order)
    m = li.shape[-1]
    Oi = torch.nn.functional.one_hot(li, n).to(dt)         # [M,N]
    Oj = torch.nn.functional.one_hot(lj, n).to(dt)
    U = (_es("mn,mac->ncma", Oi, lJi, batched=bat)
         + _es("mn,mac->ncma", Oj, lJj, batched=bat)).reshape(
        g.poses.shape[:-2] + (n, 3, 3 * m))
    return (_Tridiag(D=D, Dt=D_true, L=L, free=free), b,
            (li, lj, lJi, lJj, lom, U), dropped)


class _PrecondState(NamedTuple):
    """Chain+Woodbury preconditioner from one linearization: the CR
    factorization of the damped chain, ``Hc⁻¹U`` and ``S⁻¹``."""
    fact: CA.CrFactor
    HinvU: torch.Tensor   # [N, 3, 3M]
    s_inv: torch.Tensor   # [3M, 3M]
    li: torch.Tensor
    lj: torch.Tensor
    lJi: torch.Tensor     # loop Jacobians frozen for the preconditioner
    lJj: torch.Tensor


def _precond_setup(td: _Tridiag, loops) -> _PrecondState:
    """Factor the damped chain and build the Woodbury correction."""
    li, lj, lJi, lJj, lom, U = loops
    m = li.shape[-1]

    fact = cr_factor(td.D, td.L)
    HinvU = cr_apply(fact, U)                               # [N,3,3M]

    # S = Ω⁻¹ (block-diagonal) + Uᵀ Hc⁻¹ U   [3M, 3M]
    UtX = lJi @ pick(HinvU, li) + lJj @ pick(HinvU, lj)     # [M,3,3M]
    if li.dim() == 1:
        S4 = UtX.reshape(m, 3, m, 3).clone()
        ar = torch.arange(m, device=li.device)
        S4[ar, :, ar, :] += inv3(lom)
        s_inv = spd_inverse(S4.reshape(3 * m, 3 * m))
    else:
        b = li.shape[0]
        eye_m = torch.eye(m, dtype=lom.dtype, device=li.device)
        S4 = UtX.reshape(b, m, 3, m, 3) + torch.einsum(
            "bmij,mn->bminj", inv3(lom), eye_m)
        s_inv = spd_inverse(S4.reshape(b, 3 * m, 3 * m), batch_dims=1)
    # the preconditioner is symmetric
    s_inv = 0.5 * (s_inv + s_inv.transpose(-1, -2))
    return _PrecondState(fact=fact, HinvU=HinvU, s_inv=s_inv, li=li, lj=lj,
                         lJi=lJi, lJj=lJj)


def _ut(lJi, lJj, li, lj, x: torch.Tensor) -> torch.Tensor:
    """Uᵀ x for ``x [..., N, 3]`` → ``[..., 3M]`` (U's columns are the
    loop Jacobians' rows; for a batch ``x [B, ..., N, 3]`` and the loop
    factors per graph). The 3×3 products here and in the matvecs are
    einsums: the blocks are the batch of one product over all of ``x``'s
    leading columns, where a broadcast ``@`` would copy every block once
    per column."""
    if li.dim() == 1:
        y = (torch.einsum("mij,...mj->...mi", lJi, x[..., li, :])
             + torch.einsum("mij,...mj->...mi", lJj, x[..., lj, :]))
    else:
        y = (torch.einsum("bmij,b...mj->b...mi", lJi, rows_of(x, li))
             + torch.einsum("bmij,b...mj->b...mi", lJj, rows_of(x, lj)))
    return y.reshape(y.shape[:-2] + (-1,))


def _precond(pst: _PrecondState, r: torch.Tensor) -> torch.Tensor:
    """M r = (Hc+λI + UΩUᵀ)⁻¹ r via Woodbury, for ``r [..., N, 3]``
    (``[B, ..., N, 3]`` for a batch)."""
    z = cr_apply_cols(pst.fact, r)
    if pst.li.dim() == 1:
        y = _ut(pst.lJi, pst.lJj, pst.li, pst.lj, z) @ pst.s_inv.T
        return z - torch.einsum("ncq,...q->...nc", pst.HinvU, y)
    b = r.shape[0]
    ut = _ut(pst.lJi, pst.lJj, pst.li, pst.lj, z)
    y = (ut.reshape(b, -1, ut.shape[-1]) @ pst.s_inv.transpose(-1, -2)
         ).reshape(ut.shape)
    return z - torch.einsum("bncq,b...q->b...nc", pst.HinvU, y)


def _h_matvec(td: _Tridiag, loops, x: torch.Tensor) -> torch.Tensor:
    """TRUE ``H x = (Hc + U Ω Uᵀ) x`` for ``x [..., N, 3]`` (``[B, ..., N,
    3]`` for a batch) — undamped diagonal blocks."""
    li, lj, lJi, lJj, lom, U = loops
    bat = li.dim() == 2
    D, L = td.Dt, td.L
    xp = torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], -2)
    xn = torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])], -2)
    Lprev = torch.cat([torch.zeros_like(L[..., :1, :, :]),
                       L[..., :-1, :, :]], -3)
    y = (_es("nij,...nj->...ni", D, x, batched=bat)
         + _es("nij,...nj->...ni", Lprev, xp, batched=bat)
         + _es("nji,...nj->...ni", L, xn, batched=bat))
    utx = _ut(lJi, lJj, li, lj, x)
    utx = utx.reshape(utx.shape[:-1] + (-1, 3))             # [...,M,3]
    w = _es("mij,...mj->...mi", lom, utx, batched=bat)
    return y + _es("ncq,...q->...nc", U, w.flatten(-2), batched=bat)


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
        x2 = x + per(alpha, p) * p
        r2 = rr - per(alpha, hp) * hp
        z2 = prec(r2)
        rz2 = dot(r2, z2)
        okb = torch.abs(rz) > 1e-30
        beta = torch.where(okb, rz2 / torch.where(okb, rz,
                                                  torch.ones_like(rz)),
                           torch.zeros_like(rz))
        rr2n = dot(r2, r2)
        better = rr2n < rr2_best
        xb2 = torch.where(per(better, x2), x2, x_best)
        rb2 = torch.where(better, rr2n, rr2_best)
        new = (k + 1, x2, r2, z2 + per(beta, p) * p, rz2, rr2n, xb2, rb2)
        old = (k, x, rr, p, rz, rr2, x_best, rr2_best)
        return tuple(torch.where(per(go, a), a, b)
                     for a, b in zip(new, old)), go

    s = masked_loop(body, (k0, x, r, z, dot(r, z), rr2, x, rr2), budget,
                    "chain.cg")
    _, x_fin, _, _, _, rr2_fin, x_best, rr2_best = s
    return _select_cg_iterate(x_fin, rr2_fin, x_best, rr2_best)


def _freeze_diverged(c_old: torch.Tensor,
                     c_new: torch.Tensor) -> torch.Tensor:
    """True where a GN iteration under a frozen preconditioner made chi2
    worse by more than an absolute slack of 1 (GN is not strictly
    monotone near convergence, where chi2 sits below the slack). The
    reference redoes only a rise of more than 4× plus the slack; a stale
    preconditioner can also stall under that: a 1024-pose hospital graph
    went 84854 → 318 → 238 → 237.5 → 252 → 278 in float32, where one
    iteration redone with a fresh preconditioner ends it at 7e-4.
    NaN-safe by the negated ``<=``: a non-finite new chi2 always counts."""
    return ~(c_new <= c_old + 1.0)


def _chain_delta_impl(g: PoseGraph, edge_mask, loop_cap: int,
                      cg_tol: float = 1e-6, cg_iters: int = 48,
                      damp: float = 1e-3,
                      table: torch.Tensor | None = None,
                      pst: _PrecondState | None = None):
    """One GN update via preconditioned CG on the CURRENT true H. ``pst``
    reuses a frozen preconditioner from an earlier linearization."""
    with span("gn.linearize"):
        td, b, loops, dropped = _assemble(g, edge_mask, loop_cap, damp=damp,
                                          table=table)
    if pst is None:
        with span("gn.precond"):
            pst = _precond_setup(td, loops)
    with span("gn.solve"):
        bb = -b
        bn = torch.clamp(torch.sum(bb * bb, dim=(-2, -1)), min=1e-30)
        dx = _pcg_best(lambda x: _h_matvec(td, loops, x),
                       lambda r: _precond(pst, r), bb, bn,
                       cg_tol * cg_tol, cg_iters)
        dx = dx * td.free[..., None].to(dx.dtype)
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
    return dx[..., inv, :], dropped


def optimize_chain(g: PoseGraph, iterations: int = 5,
                   edge_mask: torch.Tensor | None = None,
                   loop_cap: int = 64, cg_tol: float = 1e-6,
                   cg_iters: int = 48, order: torch.Tensor | None = None,
                   return_dropped: bool = False, damp: float = 1e-3,
                   cg_schedule: tuple | None = None,
                   freeze_precond: bool = False):
    """``optimize(n)`` on the chain+Woodbury path: n GN iterations, oplus
    update. ``order`` solves under a slot permutation (the result is in
    original slot order); ``return_dropped`` adds the largest loop-edge
    overflow count (per graph for a batch).

    ``cg_schedule`` caps CG per GN iteration (one budget for each, at most
    ``cg_iters``). ``freeze_precond`` builds the preconditioner once, from
    the first linearization, and reuses it; a GN iteration whose chi2
    :func:`_freeze_diverged` flags is redone with a fresh preconditioner,
    per graph. The guard reads the number of flagged graphs on the host
    once per GN iteration (not per graph) and computes the redo only when
    one was flagged (for the whole batch, then selected per graph);
    :data:`FREEZE_REDOS` counts the graphs redone."""
    if order is not None:
        inv = inverse_permutation(order).long()
        gp, dropped = optimize_chain(
            permute_vertices(g, order), iterations, edge_mask, loop_cap,
            cg_tol, cg_iters, return_dropped=True, damp=damp,
            cg_schedule=cg_schedule, freeze_precond=freeze_precond)
        out = dataclasses.replace(g, poses=gp.poses[..., inv, :])
        return (out, dropped) if return_dropped else out

    if cg_schedule is None:
        sched = (cg_iters,) * iterations
    else:
        assert len(cg_schedule) == iterations, \
            "cg_schedule needs one CG budget per GN iteration"
        sched = tuple(min(cg_iters, int(c)) for c in cg_schedule)
    dmax = torch.zeros(g.poses.shape[:-2], dtype=torch.int32,
                       device=g.poses.device)
    table = _edge_table(g, edge_mask)
    pst = None
    if freeze_precond:
        with span("gn.linearize"):
            td0, _, loops0, _ = _assemble(g, edge_mask, loop_cap, damp=damp,
                                          table=table)
        with span("gn.precond"):
            pst = _precond_setup(td0, loops0)
    for budget in sched:
        dx, dropped = _chain_delta_impl(g, edge_mask, loop_cap,
                                        cg_tol=cg_tol, cg_iters=budget,
                                        damp=damp, table=table, pst=pst)
        with span("gn.update"):
            poses = se2.oplus(g.poses, dx)
        if pst is not None:
            bad = _freeze_diverged(chi2(g, edge_mask),
                                   chi2(dataclasses.replace(g, poses=poses),
                                        edge_mask))
            n_bad = int(torch.sum(bad.to(torch.int32)))
            count("host_read.chain.freeze_guard")
            if n_bad:
                FREEZE_REDOS["optimize_chain"] += n_bad
                dx2, dr2 = _chain_delta_impl(g, edge_mask, loop_cap,
                                             cg_tol=cg_tol, cg_iters=budget,
                                             damp=damp, table=table)
                poses = torch.where(per(bad, poses),
                                    se2.oplus(g.poses, dx2), poses)
                dropped = torch.where(bad, dr2, dropped)
        g = dataclasses.replace(g, poses=poses)
        dmax = torch.maximum(dmax, dropped)
        count("gn.iters.chain")
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
    columns, each column with its own exit. A batch takes ``query``
    ``[Q]`` (every graph) or ``[B, Q]`` and gives ``[B, Q, 3, 3]``."""
    if order is not None:
        inv = inverse_permutation(order).long()
        return marginal_covariance_chain(
            permute_vertices(g, order), inv[query.long()], edge_mask,
            loop_cap, cg_tol, cg_iters, None, damp)
    td, _, loops, _ = _assemble(g, edge_mask, loop_cap, damp=damp)
    pst = _precond_setup(td, loops)
    one = torch.ones((), dtype=g.poses.dtype, device=g.poses.device)
    rhs, rows = unit_columns(query, g.poses)
    x = _pcg_best(lambda v: _h_matvec(td, loops, v),
                  lambda r: _precond(pst, r), rhs, one, cg_tol * cg_tol,
                  cg_iters)
    return marginal_blocks(x, rows)
