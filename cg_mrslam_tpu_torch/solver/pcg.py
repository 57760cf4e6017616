"""Matrix-free preconditioned conjugate gradient for large pose graphs.

Port of ``cg_mrslam_tpu/solver/pcg.py``: the Hessian is never formed — a
Hessian-vector product is a pass over the edges and a sum over each
vertex's edge ends (in the order of the solve's segment table,
``solver/fixed_sum.py``: one fixed order, bit-identical on repeat, where
the reference scatter-adds; on the card a hand-written kernel pair,
``ops/pcg_hvp.py``, on the CPU its plain version) — and CG
is preconditioned by the damped (chain-tridiagonal +
full-diagonal) matrix factorized by cyclic reduction
(``solver/cyclic_reduction.py``, shared with the chain band; its solve on
the card one kernel). The fallback of the chain band for graphs that are
not ``chainable``.

The reference's ``lax.scan``s of fixed length freeze their state once a
``done`` test passes; here the GN step and the marginal columns run one
CG body (:func:`_masked_pcg`) as a :func:`solver.spd.masked_loop` with
the same freeze, which stops early once every system is frozen (the same
iterates); its vector updates are two calls of ``ops/cg_update.py`` an
iteration (on the card one kernel each, skipping frozen systems).

Every entry point also takes a graph with a leading batch axis (the
reference ``vmap``s over it) and one ``order`` for every graph: one
segment table over the batch, and each graph's CG freezes on its own
``done`` test. Batch-1 calls keep their own operations and bits.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import (PoseGraph, degrees,
                                            inverse_permutation,
                                            permute_vertices, unpack_info)
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.ops.cg_update import (cg_update_a, cg_update_b, dot,
                                               free_mask)
from cg_mrslam_tpu_torch.ops.pcg_hvp import PCG_HVP
from cg_mrslam_tpu_torch.solver.cyclic_reduction import (GROUP,
                                                         cr_apply_cols,
                                                         cr_factor)
from cg_mrslam_tpu_torch.solver.fixed_sum import (Segments, edge_table,
                                                  ends_sum)
from cg_mrslam_tpu_torch.solver.gather import (marginal_blocks, rows_of,
                                               unit_columns)
from cg_mrslam_tpu_torch.solver.spd import masked_loop, per
from cg_mrslam_tpu_torch.utils import se2
from cg_mrslam_tpu_torch.utils.metrics import count, span


class EdgeFactors(NamedTuple):
    """Per-edge linearization reused across CG iterations."""

    Ji: torch.Tensor      # [E, 3, 3]
    Jj: torch.Tensor      # [E, 3, 3]
    omega: torch.Tensor   # [E, 3, 3] masked information
    b: torch.Tensor       # [N, 3] gradient blocks (Σ JᵀΩe)
    diag: torch.Tensor    # [N, 3, 3] diagonal Hessian blocks
    free: torch.Tensor    # [N] bool
    segs: Segments        # each vertex's active edge ends (the table, and
    #                       its compressed rows as int32 for the kernel)
    # (a batch: the per-edge and per-vertex fields with a leading [B]; the
    # segments over the flattened [B·N] vertices and [2, B, E] edge ends)


def _edge_table(g: PoseGraph, edge_mask) -> Segments:
    """The solve's segments (``solver/fixed_sum.py``): fixed for a solve,
    so built once (one host read) and passed to every
    :func:`_factorize`."""
    mask = g.emask if edge_mask is None else edge_mask
    segs = edge_table(g.e_ij, mask, g.poses.shape[-2])
    return segs._replace(entries=segs.entries.int(),
                         offsets=segs.offsets.int())


def _factorize(g: PoseGraph, edge_mask,
               segs: Segments | None = None) -> EdgeFactors:
    mask = g.emask if edge_mask is None else edge_mask
    if segs is None:
        segs = _edge_table(g, edge_mask)
    nb = g.poses.dim() - 2
    dt = g.poses.dtype
    e, Ji, Jj = linearize(g.poses, g.e_ij, g.e_z)
    omega = unpack_info(g.e_info) * mask.to(dt)[..., None, None]
    JiT_O = Ji.transpose(-1, -2) @ omega
    JjT_O = Jj.transpose(-1, -2) @ omega
    bi = (JiT_O @ e[..., None])[..., 0]
    bj = (JjT_O @ e[..., None])[..., 0]
    Hii = JiT_O @ Ji
    Hjj = JjT_O @ Jj

    free = g.vmask & ~g.fixed & (degrees(g.e_ij, mask, g.poses.shape[-2])
                                 > 0)
    b = ends_sum(segs.table, bi, bj, nb)
    diag = ends_sum(segs.table, Hii, Hjj, nb)
    return EdgeFactors(Ji=Ji, Jj=Jj, omega=omega, b=b, diag=diag, free=free,
                       segs=segs)


def _tridiag_factor(g: PoseGraph, f: EdgeFactors, damp: float = 1e-3):
    """Damped (chain-tridiagonal + full-diagonal) preconditioner,

        T = (Hessian diagonal blocks) + (adjacent-slot chain off-diagonal
            blocks) + λI,     λ = damp·mean-diag,

    factorized by cyclic reduction (the compact factor of
    ``ops/cr_apply.py``)."""
    nb = g.poses.dim() - 2
    n = g.poses.shape[-2]
    dt = g.poses.dtype
    dev = g.poses.device
    vi, vj = g.e_ij[..., 0].long(), g.e_ij[..., 1].long()
    eye = torch.eye(3, dtype=dt, device=dev)
    free = f.free
    diag_free = torch.where(free[..., None, None], f.diag,
                            torch.zeros_like(f.diag))
    diag_scale = torch.sum(torch.diagonal(diag_free, dim1=-2, dim2=-1),
                           dim=(-2, -1)) \
        / torch.clamp(3.0 * torch.sum(free.to(dt), dim=-1), min=1.0)
    lam = per(damp * diag_scale + 1e-6, f.diag)
    D = torch.where(free[..., None, None], f.diag + lam * eye, eye)

    # chain off-diagonals: adjacent-slot edges with both ends free (omega
    # is already zero on masked edges)
    cm = ((vj == vi + 1) & free.gather(-1, vi) & free.gather(-1, vj)).to(dt)
    Hij = (f.Ji.transpose(-1, -2) @ f.omega @ f.Jj) * cm[..., None, None]
    L = ends_sum(f.segs.table, Hij.transpose(-1, -2), torch.zeros_like(Hij),
                 nb)
    L[..., n - 1, :, :] = 0.0

    return cr_factor(D, L, group=GROUP)


def _tridiag_precond(g: PoseGraph, f: EdgeFactors, damp: float = 1e-3):
    """:func:`_tridiag_factor`'s preconditioner as ``precond(r [..., N,
    3])``: the solve of every column of ``r``, frozen vertices' rows zero
    (on the card one kernel launch)."""
    fact = _tridiag_factor(g, f, damp)

    def precond(r: torch.Tensor) -> torch.Tensor:
        return cr_apply_cols(fact, r, f.free)

    return precond


def _hvp(g: PoseGraph, f: EdgeFactors, x: torch.Tensor) -> torch.Tensor:
    """``H @ x`` for ``x [*B, *C, N, 3]`` (a batch's graph axis first, then
    any column axes): on the card the kernel pair
    (:data:`ops.pcg_hvp.PCG_HVP`), elsewhere :func:`_hvp_plain`."""
    if x.is_cuda:
        return PCG_HVP(g.e_ij, f.Ji, f.Jj, f.omega, f.segs.entries,
                       f.segs.offsets, f.free, x)
    return _hvp_plain(g, f, x)


def _hvp_plain(g: PoseGraph, f: EdgeFactors, x: torch.Tensor):
    """:func:`_hvp` in plain PyTorch: per edge ``w = Ω (Jᵢ xᵢ + Jⱼ xⱼ)``,
    its ends' ``Jᵢᵀ w`` and ``Jⱼᵀ w``, and per vertex the sum of its ends
    through the segment table (one fixed order), times ``free``."""
    nb = g.poses.dim() - 2
    n = x.shape[-2]
    vi, vj = g.e_ij[..., 0].long(), g.e_ij[..., 1].long()
    xf = x.reshape(x.shape[:nb] + (-1, n, 3))              # [*B, C, N, 3]

    def ends(v):                  # x at one end of every edge: [*B, E, C, 3]
        return (rows_of(xf, v) if nb else xf[:, v]).movedim(nb, -2)

    xi, xj = ends(vi), ends(vj)

    def mv(m, v):                                # [*B, E, 3, 3] @ [.., C, 3]
        return (m[..., None, :, :] @ v[..., None])[..., 0]

    w = mv(f.omega, mv(f.Ji, xi) + mv(f.Jj, xj))
    y = ends_sum(f.segs.table, mv(f.Ji.transpose(-1, -2), w),
                 mv(f.Jj.transpose(-1, -2), w), nb)
    return y.movedim(-2, nb).reshape(x.shape) * free_mask(f.free, x)


def _in_span(name: str, fn):
    """``fn`` with each call inside the span ``name``."""
    def call(x):
        with span(name):
            return fn(x)
    return call


def _masked_pcg(hvp, precond, rhs: torch.Tensor, z0: torch.Tensor,
                free: torch.Tensor, budget: int, tol: float, name: str,
                spans: str, graph: bool, new_residual: bool,
                jitter: float = 0.0) -> torch.Tensor:
    """CG from zero on ``rhs [..., N, 3]``, ``z0 = precond(rhs)``, for
    ``H + jitter·diag(free)`` with ``H p = hvp(p)``; each system freezes
    on its own ``done`` test, as the reference's: on the new residual
    (``new_residual``, the GN step: a step below ``tol`` is not taken) or
    on the one the iteration starts from (the marginal columns). The loop
    is :func:`solver.spd.masked_loop` ``name``. An iteration: ``hvp``
    (span ``<spans>.hvp``), update A, ``precond`` (``<spans>.precond_apply``),
    update B (each update in a span ``<spans>.update``;
    ``ops/cg_update.py``: on the card one kernel each, writing the loop's
    own copies of ``rhs`` and ``z0`` in place)."""
    hvp = _in_span(f"{spans}.hvp", hvp)
    precond = _in_span(f"{spans}.precond_apply", precond)
    update = f"{spans}.update"

    def body(s):
        x, r, p, rz, active = s
        hp = hvp(p)
        with span(update):
            x, r, active = cg_update_a(x, r, p, hp, rz, active, free, jitter,
                                       tol, new_residual)
        z = precond(r)
        with span(update):
            p, rz = cg_update_b(r, z, p, rz, active)
        return (x, r, p, rz, active), active

    rz = dot(rhs, z0)
    active = torch.ones(rz.shape, dtype=torch.bool, device=rz.device)
    x, *_ = masked_loop(body, (torch.zeros_like(rhs), rhs.clone(),
                               z0.clone(), rz, active), budget, name,
                        graph=graph)
    return x


def pcg_delta(g: PoseGraph, edge_mask: torch.Tensor | None = None,
              cg_iters: int = 64, tol: float = 1e-8,
              segs: Segments | None = None,
              cg_graph: bool = False) -> torch.Tensor:
    """One GN update direction ``dx [N,3]`` by chain-preconditioned PCG
    on the true Hessian. As in the reference, a step whose new residual
    falls below ``tol`` is not taken: the state stays frozen before it
    (per graph of a batch). ``segs``: the solve's :func:`_edge_table`
    (built here if not given). ``cg_graph``: on the card, replay the CG
    iterations between the host's looks as one captured CUDA graph
    (:func:`solver.spd.masked_loop`), for systems too small to keep the
    device busy. The CG body's spans: ``pcg.hvp``, ``pcg.update`` and
    ``pcg.precond_apply``."""
    with span("gn.linearize"):
        f = _factorize(g, edge_mask, segs)
    with span("gn.precond"):
        precond = _tridiag_precond(g, f)
    with span("gn.solve"):
        b = -f.b * free_mask(f.free, f.b)
        return _masked_pcg(lambda p: _hvp(g, f, p), precond, b, precond(b),
                           f.free, cg_iters, tol, "pcg.cg", "pcg", cg_graph,
                           new_residual=True)


def marginal_covariance_pcg(g: PoseGraph, query: torch.Tensor,
                            edge_mask: torch.Tensor | None = None,
                            cg_iters: int = 160, tol: float = 1e-12,
                            order: torch.Tensor | None = None,
                            cg_graph: bool = False) -> torch.Tensor:
    """Marginal 3×3 covariance blocks ``[Q,3,3]`` by matrix-free PCG
    column solves (one linearization and factorization for all 3Q unit
    columns, batched), with the dense path's semantics: gauge from
    ``g.fixed``, the same 1e-6 jitter, the identity block for a queried
    vertex that is not free. A batch takes ``query`` ``[Q]`` (every
    graph) or ``[B, Q]`` and gives ``[B, Q, 3, 3]``. The CG body's spans:
    ``marginal.hvp`` (the product alone: the jitter is added in the
    update), ``marginal.update`` and ``marginal.precond_apply``.
    ``cg_graph``: as :func:`pcg_delta`'s."""
    if order is not None:
        inv = inverse_permutation(order).long()
        return marginal_covariance_pcg(permute_vertices(g, order),
                                       inv[query.long()], edge_mask,
                                       cg_iters, tol, cg_graph=cg_graph)
    f = _factorize(g, edge_mask)
    eye = torch.eye(3, dtype=g.poses.dtype, device=g.poses.device)
    precond = _tridiag_precond(g, f)
    rhs, rows = unit_columns(query, g.poses)
    rhs = rhs * free_mask(f.free, rhs)
    x = _masked_pcg(lambda p: _hvp(g, f, p), precond, rhs, precond(rhs),
                    f.free, cg_iters, tol, "pcg.marginal", "marginal",
                    cg_graph, new_residual=False, jitter=1e-6)
    free_q = f.free.gather(-1, rows[..., ::3])
    return torch.where(free_q[..., None, None], marginal_blocks(x, rows), eye)


def optimize_pcg(g: PoseGraph, iterations: int = 5,
                 edge_mask: torch.Tensor | None = None,
                 cg_iters: int = 64,
                 order: torch.Tensor | None = None,
                 cg_graph: bool = False) -> PoseGraph:
    """GN iterations with PCG inner solves. ``order`` solves under a slot
    permutation (the tridiagonal preconditioner keys on slot-adjacent
    edges) and returns poses in original slot order. ``cg_graph``: as
    :func:`pcg_delta`'s."""
    if order is not None:
        inv = inverse_permutation(order).long()
        gp = optimize_pcg(permute_vertices(g, order), iterations, edge_mask,
                          cg_iters, cg_graph=cg_graph)
        return dataclasses.replace(g, poses=gp.poses[..., inv, :])
    segs = _edge_table(g, edge_mask)
    for _ in range(iterations):
        dx = pcg_delta(g, edge_mask, cg_iters=cg_iters, segs=segs,
                       cg_graph=cg_graph)
        with span("gn.update"):
            g = dataclasses.replace(g, poses=se2.oplus(g.poses, dx))
        count("gn.iters.pcg")
    return g
