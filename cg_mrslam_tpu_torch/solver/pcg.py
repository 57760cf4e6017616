"""Matrix-free preconditioned conjugate gradient for large pose graphs.

Port of ``cg_mrslam_tpu/solver/pcg.py``: the Hessian is never formed — a
Hessian-vector product is gathers and a sum over each vertex's edges
(through the solve's segment table, ``solver/fixed_sum.py``: one fixed
order, bit-identical on repeat, where the reference scatter-adds) — and CG
is preconditioned by the damped (chain-tridiagonal +
full-diagonal) matrix factorized with the chain solver's cyclic
reduction. The fallback of the chain band for graphs that are not
``chainable``.

The reference's ``lax.scan``s of fixed length freeze their state once a
``done`` test passes; here they are :func:`solver.spd.masked_loop`s with
the same freeze, which stop early once every system is frozen (the same
iterates).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, inverse_permutation,
                                            permute_vertices, unpack_info)
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.solver.chain import GROUP, _cr_apply, _cr_factor
from cg_mrslam_tpu_torch.solver.fixed_sum import edge_table, segment_sum
from cg_mrslam_tpu_torch.solver.spd import masked_loop
from cg_mrslam_tpu_torch.utils import se2


class EdgeFactors(NamedTuple):
    """Per-edge linearization reused across CG iterations."""

    Ji: torch.Tensor      # [E, 3, 3]
    Jj: torch.Tensor      # [E, 3, 3]
    omega: torch.Tensor   # [E, 3, 3] masked information
    b: torch.Tensor       # [N, 3] gradient blocks (Σ JᵀΩe)
    diag: torch.Tensor    # [N, 3, 3] diagonal Hessian blocks
    free: torch.Tensor    # [N] bool
    table: torch.Tensor   # [N, W] each vertex's active edge ends
    hvp_edge: torch.Tensor  # [N, W] the edge of each table entry
    hvp_J: torch.Tensor     # [N, W, 3, 3] its Jacobian at this vertex (0: pad)


def _edge_table(g: PoseGraph, edge_mask) -> torch.Tensor:
    """The solve's segment table (``solver/fixed_sum.py``): fixed for a
    solve, so built once (one host read) and passed to every
    :func:`_factorize`."""
    mask = g.emask if edge_mask is None else edge_mask
    return edge_table(g.e_ij, mask, g.poses.shape[0])


def _factorize(g: PoseGraph, edge_mask,
               table: torch.Tensor | None = None) -> EdgeFactors:
    mask = g.emask if edge_mask is None else edge_mask
    if table is None:
        table = _edge_table(g, edge_mask)
    dt = g.poses.dtype
    dev = g.poses.device
    e, Ji, Jj = linearize(g.poses, g.e_ij, g.e_z)
    omega = unpack_info(g.e_info) * mask.to(dt)[:, None, None]
    JiT_O = Ji.transpose(1, 2) @ omega
    JjT_O = Jj.transpose(1, 2) @ omega
    bi = (JiT_O @ e[:, :, None])[:, :, 0]
    bj = (JjT_O @ e[:, :, None])[:, :, 0]
    Hii = JiT_O @ Ji
    Hjj = JjT_O @ Jj

    n = g.poses.shape[0]
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    b = segment_sum(table, torch.cat([bi, bj]))
    diag = segment_sum(table, torch.cat([Hii, Hjj]))
    em = mask.to(torch.int32)
    deg = torch.zeros((n,), dtype=torch.int32, device=dev)
    deg.index_add_(0, vi, em)
    deg.index_add_(0, vj, em)
    free = g.vmask & ~g.fixed & (deg > 0)
    # the table's entries as (edge, Jacobian) pairs for the HVP: entry
    # k < E is edge k's i end, E + k its j end, 2E the zero pad
    ne = Ji.shape[0]
    edge_of = torch.arange(2 * ne + 1, device=dev) % ne
    J2 = torch.cat([Ji, Jj, torch.zeros_like(Ji[:1])])
    return EdgeFactors(Ji=Ji, Jj=Jj, omega=omega, b=b, diag=diag, free=free,
                       table=table, hvp_edge=edge_of[table], hvp_J=J2[table])


def _tridiag_precond(g: PoseGraph, f: EdgeFactors, damp: float = 1e-3):
    """Damped (chain-tridiagonal + full-diagonal) preconditioner,

        T = (Hessian diagonal blocks) + (adjacent-slot chain off-diagonal
            blocks) + λI,     λ = damp·mean-diag,

    factorized by cyclic reduction. Returns ``precond(r [..., N, 3])``."""
    n = g.poses.shape[0]
    dt = g.poses.dtype
    dev = g.poses.device
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    eye = torch.eye(3, dtype=dt, device=dev)
    free = f.free
    freeb = free[:, None].to(dt)
    diag_free = torch.where(free[:, None, None], f.diag,
                            torch.zeros_like(f.diag))
    diag_scale = torch.sum(torch.diagonal(diag_free, dim1=-2, dim2=-1)) \
        / torch.clamp(3.0 * torch.sum(free.to(dt)), min=1.0)
    lam = damp * diag_scale + 1e-6
    D = torch.where(free[:, None, None], f.diag + lam * eye, eye)

    # chain off-diagonals: adjacent-slot edges with both ends free (omega
    # is already zero on masked edges)
    cm = ((vj == vi + 1) & free[vi] & free[vj]).to(dt)
    Hij = (f.Ji.transpose(1, 2) @ f.omega @ f.Jj) * cm[:, None, None]
    L = segment_sum(f.table, torch.cat([Hij.transpose(1, 2),
                                        torch.zeros_like(Hij)]))
    L[n - 1] = 0.0

    fact = _cr_factor(D, L, group=GROUP)

    def precond(r: torch.Tensor) -> torch.Tensor:
        lead = r.shape[:-2]
        cols = (r * freeb).reshape(-1, n, 3).permute(1, 2, 0)   # [N,3,C]
        x = _cr_apply(fact, cols).permute(2, 0, 1).reshape(lead + (n, 3))
        return x * freeb

    return precond


def _hvp(g: PoseGraph, f: EdgeFactors, x: torch.Tensor) -> torch.Tensor:
    """``H @ x`` for ``x [..., N, 3]``: gathers, and per vertex one sum over
    its table of edges (a fixed order)."""
    vi, vj = g.e_ij[:, 0].long(), g.e_ij[:, 1].long()
    # w = Ω (Jᵢ xᵢ + Jⱼ xⱼ) per edge (the edges are the batch of each einsum
    # over all of x's leading columns); then y_n = Σ over n's table entries
    # of Jᵀ w, one product contracting each vertex's entries and their 3
    # components together
    u = (torch.einsum("eij,...ej->...ei", f.Ji, x[..., vi, :])
         + torch.einsum("eij,...ej->...ei", f.Jj, x[..., vj, :]))
    w = torch.einsum("eij,...ej->...ei", f.omega, u)
    y = torch.einsum("nwji,...nwj->...ni", f.hvp_J, w[..., f.hvp_edge, :])
    return y * f.free[:, None].to(x.dtype)


def _dot(a, b):
    return torch.sum(a * b, dim=(-2, -1))


def pcg_delta(g: PoseGraph, edge_mask: torch.Tensor | None = None,
              cg_iters: int = 64, tol: float = 1e-8,
              table: torch.Tensor | None = None) -> torch.Tensor:
    """One GN update direction ``dx [N,3]`` by chain-preconditioned PCG
    on the true Hessian. As in the reference, a step whose new residual
    falls below ``tol`` is not taken: the state stays frozen before it.
    ``table``: the solve's :func:`_edge_table` (built here if not given)."""
    f = _factorize(g, edge_mask, table)
    freeb = f.free[:, None].to(g.poses.dtype)
    precond = _tridiag_precond(g, f)
    b = -f.b * freeb
    z0 = precond(b)

    def body(s):
        x, r, z, p, rz = s
        hp = _hvp(g, f, p)
        alpha = rz / torch.clamp(_dot(p, hp), min=1e-30)
        x2 = x + alpha * p
        r2 = r - alpha * hp
        z2 = precond(r2)
        rz2 = _dot(r2, z2)
        beta = rz2 / torch.clamp(rz, min=1e-30)
        p2 = z2 + beta * p
        done = _dot(r2, r2) < tol
        new = (x2, r2, z2, p2, rz2)
        return tuple(torch.where(done, o, nw)
                     for o, nw in zip(s, new)), ~done

    x, *_ = masked_loop(body, (torch.zeros_like(b), b, z0, z0, _dot(b, z0)),
                        cg_iters)
    return x


def marginal_covariance_pcg(g: PoseGraph, query: torch.Tensor,
                            edge_mask: torch.Tensor | None = None,
                            cg_iters: int = 160, tol: float = 1e-12,
                            order: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Marginal 3×3 covariance blocks ``[Q,3,3]`` by matrix-free PCG
    column solves (one linearization and factorization for all 3Q unit
    columns, batched), with the dense path's semantics: gauge from
    ``g.fixed``, the same 1e-6 jitter, the identity block for a queried
    vertex that is not free."""
    if order is not None:
        inv = inverse_permutation(order).long()
        return marginal_covariance_pcg(permute_vertices(g, order),
                                       inv[query.long()], edge_mask,
                                       cg_iters, tol)
    dt = g.poses.dtype
    dev = g.poses.device
    f = _factorize(g, edge_mask)
    freeb = f.free[:, None].to(dt)
    eye = torch.eye(3, dtype=dt, device=dev)
    n = g.poses.shape[0]
    precond = _tridiag_precond(g, f)

    def hvp(x):
        return _hvp(g, f, x) + 1e-6 * x * freeb

    q = query.shape[0]
    qs = torch.repeat_interleave(query.long(), 3)              # [3Q]
    cs = torch.arange(3, device=dev).repeat(q)                 # [3Q]
    ar = torch.arange(3 * q, device=dev)
    rhs = torch.zeros((3 * q, n, 3), dtype=dt, device=dev)
    rhs[ar, qs, cs] = torch.ones((), dtype=dt, device=dev)
    rhs = rhs * freeb

    def col(v):
        return v[..., None, None]

    def body(s):
        x, r, z, p, rz = s
        hp = hvp(p)
        alpha = rz / torch.clamp(_dot(p, hp), min=1e-30)
        x2 = x + col(alpha) * p
        r2 = r - col(alpha) * hp
        z2 = precond(r2)
        rz2 = _dot(r2, z2)
        beta = rz2 / torch.clamp(rz, min=1e-30)
        p2 = z2 + col(beta) * p
        done = _dot(r, r) < tol
        new = (x2, r2, z2, p2, rz2)
        return tuple(torch.where(col(done) if o.dim() > 1 else done, o, nw)
                     for o, nw in zip(s, new)), ~done

    z0 = precond(rhs)
    x, *_ = masked_loop(body, (torch.zeros_like(rhs), rhs, z0, z0,
                               _dot(rhs, z0)), cg_iters)
    cols = x[ar, qs]                                           # [3Q, 3]
    sig = cols.reshape(q, 3, 3).transpose(-1, -2)
    sig = torch.where(f.free[query.long()][:, None, None], sig, eye)
    return 0.5 * (sig + sig.transpose(-1, -2))


def optimize_pcg(g: PoseGraph, iterations: int = 5,
                 edge_mask: torch.Tensor | None = None,
                 cg_iters: int = 64,
                 order: torch.Tensor | None = None) -> PoseGraph:
    """GN iterations with PCG inner solves. ``order`` solves under a slot
    permutation (the tridiagonal preconditioner keys on slot-adjacent
    edges) and returns poses in original slot order."""
    if order is not None:
        inv = inverse_permutation(order).long()
        gp = optimize_pcg(permute_vertices(g, order), iterations, edge_mask,
                          cg_iters)
        return dataclasses.replace(g, poses=gp.poses[inv])
    table = _edge_table(g, edge_mask)
    for _ in range(iterations):
        dx = pcg_delta(g, edge_mask, cg_iters=cg_iters, table=table)
        g = dataclasses.replace(g, poses=se2.oplus(g.poses, dx))
    return g
