"""Dense Gauss–Newton for SE(2) pose graphs and the capacity bands.

Port of ``cg_mrslam_tpu/solver/gauss_newton.py`` (g2o ``SparseOptimizer`` +
``OptimizationAlgorithmGaussNewton``, driven by ``optimize(n)``, reference
``graph_slam.cpp:561-574``). The Hessian is a dense ``[3N, 3N]`` matrix,
solved by Cholesky (``chol=True``, the batch-1 live path) or by the
explicit SPD inverse with a dense CG polish (``chol=False``, the
reference's default, ``solver/spd.py``). The ``*_auto`` entry points pick
the band from the graph's capacity: dense up to ``DENSE_MAX`` (or
``DENSE_MAX_CHOL`` with ``chol``), then chain+Woodbury
(``solver/chain.py``) where the graph is chainable and matrix-free PCG
(``solver/pcg.py``) where it is not; PCG above ``PCG_MIN``.

Assembly keeps the reference's one-hot selection products: a scatter-add
on the card would add the per-edge blocks with atomics, in an order that
changes from run to run; a product with the one-hot matrices adds them in
one fixed order (bit-identical on repeat) and needs no host
synchronization. Its work grows with N²·E, which the dense band bounds.
One substitution of a TPU-only form:

* ``cho_factor``/``cho_solve`` become ``torch.linalg.cholesky_ex`` +
  ``torch.cholesky_solve``: no host sync, and a matrix that is not positive
  definite yields NaN as ``jax.scipy.linalg.cho_factor`` does, instead of
  raising.

The reference's ``lax.cond`` between the chain band and PCG reads its
predicate on the host here: one device-to-host read per banded call.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph, unpack_info
from cg_mrslam_tpu_torch.core.linearize import linearize
from cg_mrslam_tpu_torch.solver import chain as CH
from cg_mrslam_tpu_torch.solver.pcg import (marginal_covariance_pcg,
                                            optimize_pcg)
from cg_mrslam_tpu_torch.solver.spd import pcg_refine, spd_inverse
from cg_mrslam_tpu_torch.utils import se2

# Capacity bands, copied unchanged from the reference (they decide which
# solver each keyframe bucket runs).
DENSE_MAX = 256
DENSE_MAX_CHOL = 512
PCG_MIN = 4096

# Which band each banded call took: ``(entry point, "dense" | "chain" |
# "pcg")`` → calls. A plain counter for runs that report it; nothing
# reads it on the solve path.
BAND_CALLS = collections.Counter()


class NormalEq(NamedTuple):
    H: torch.Tensor      # [3N, 3N]
    b: torch.Tensor      # [3N]  (gradient: Σ Jᵀ Ω e)
    free3: torch.Tensor  # [3N] float — 1.0 on free coordinates


def _free_mask(g: PoseGraph, edge_mask: torch.Tensor) -> torch.Tensor:
    """Free vertices: live, not gauge-fixed, and touched by at least one
    active edge (unconstrained vertices would make H singular, so they are
    pinned like fixed vertices)."""
    n = g.poses.shape[0]
    em = edge_mask.to(torch.int32)
    deg = torch.zeros((n,), dtype=torch.int32, device=g.poses.device)
    deg.index_add_(0, g.e_ij[:, 0].long(), em)
    deg.index_add_(0, g.e_ij[:, 1].long(), em)
    return g.vmask & ~g.fixed & (deg > 0)


def build_normal_equations(g: PoseGraph,
                           edge_mask: torch.Tensor | None = None
                           ) -> NormalEq:
    """Assemble H = Σ JᵀΩJ and b = Σ JᵀΩe over active edges: the four 3×3
    blocks of every edge summed into an ``[N, 3, N, 3]`` block array by
    one-hot products (a fixed order; bit-identical on repeat)."""
    n = g.poses.shape[0]
    dt = g.poses.dtype
    emask_b = g.emask if edge_mask is None else edge_mask
    mask = emask_b.to(dt)

    e, Ji, Jj = linearize(g.poses, g.e_ij, g.e_z)
    omega = unpack_info(g.e_info) * mask[:, None, None]

    JiT_O = Ji.transpose(1, 2) @ omega      # Jᵢᵀ Ω  [E,3,3]
    JjT_O = Jj.transpose(1, 2) @ omega
    Hii = JiT_O @ Ji
    Hij = JiT_O @ Jj
    Hjj = JjT_O @ Jj
    bi = (JiT_O @ e[:, :, None])[:, :, 0]
    bj = (JjT_O @ e[:, :, None])[:, :, 0]

    # every block summed by products with the one-hot endpoint matrices
    # (the reference's form): off[a, i, b, j] = Σ_e [vi=a] Hij[e,i,j] [vj=b]
    ar = torch.arange(n, device=g.poses.device)
    oi = (g.e_ij[:, 0, None] == ar[None]).to(dt)            # [E,N]
    oj = (g.e_ij[:, 1, None] == ar[None]).to(dt)
    ne = Hij.shape[0]
    diag = (oi.T @ Hii.reshape(ne, 9) + oj.T @ Hjj.reshape(ne, 9))
    off = (oi.T @ (Hij.reshape(ne, 9, 1) * oj[:, None, :]).reshape(
        ne, 9 * n)).reshape(n, 3, 3, n).permute(0, 1, 3, 2)  # [a,i,b,j]
    H4 = off + off.permute(2, 3, 0, 1)
    H4[ar, :, ar, :] += diag.reshape(n, 3, 3)
    H = H4.reshape(3 * n, 3 * n)
    bv = oi.T @ bi + oj.T @ bj

    free3 = torch.repeat_interleave(_free_mask(g, emask_b), 3).to(dt)
    return NormalEq(H=H, b=bv.reshape(3 * n), free3=free3)


def _gauge_fix(H: torch.Tensor, b: torch.Tensor, free3: torch.Tensor):
    """Project out fixed/unused coordinates; unit diagonal keeps H PD."""
    Hf = H * free3[:, None] * free3[None, :]
    Hf = Hf + torch.diag(1.0 - free3)
    return Hf, b * free3


def _cholesky(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN (not an exception, not a host sync) when
    ``H`` is not positive definite — ``cho_factor``'s behaviour."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def solve_normal_equations(eq: NormalEq, chol: bool = False
                           ) -> torch.Tensor:
    """dx = -H⁻¹ b. ``chol`` factorizes (the batch-1 live path); otherwise
    the explicit SPD inverse (``solver.spd``) preconditions and warm-starts
    a dense CG polish (the reference's default)."""
    H, b = _gauge_fix(eq.H, eq.b, eq.free3)
    if chol:
        dx = -torch.cholesky_solve(b[:, None], _cholesky(H))[:, 0]
    else:
        dx = -pcg_refine(H, b[:, None], spd_inverse(H))[:, 0]
    return dx * eq.free3


def gn_step(g: PoseGraph, edge_mask: torch.Tensor | None = None,
            chol: bool = False) -> PoseGraph:
    """One linearize → solve → oplus update (g2o GN iteration)."""
    dx = solve_normal_equations(build_normal_equations(g, edge_mask),
                                chol=chol)
    return dataclasses.replace(g, poses=se2.oplus(g.poses, dx.reshape(-1, 3)))


def optimize(g: PoseGraph, iterations: int = 5,
             edge_mask: torch.Tensor | None = None,
             chol: bool = False) -> PoseGraph:
    """``GraphSLAM::optimize(n)``: n Gauss–Newton iterations. Without
    ``chol`` the SPD inverse is computed once, for the first
    linearization, and preconditions the CG polish of every iteration's
    fresh normal equations (tolerance 1e-7), as in the reference."""
    if iterations <= 0:
        return g
    if chol:
        for _ in range(iterations):
            g = gn_step(g, edge_mask, chol=True)
        return g
    minv = None
    for _ in range(iterations):
        eq = build_normal_equations(g, edge_mask)
        H, b = _gauge_fix(eq.H, eq.b, eq.free3)
        if minv is None:
            minv = spd_inverse(H)
        dx = -pcg_refine(H, b[:, None], minv, tol=1e-7)[:, 0] * eq.free3
        g = dataclasses.replace(g, poses=se2.oplus(g.poses,
                                                   dx.reshape(-1, 3)))
    return g


def _dense_max(chol: bool) -> int:
    return DENSE_MAX_CHOL if chol else DENSE_MAX


def _chainable(g, edge_mask, loop_cap, order) -> bool:
    """The chain band's runtime check, read on the host: the reference's
    ``lax.cond`` predicate (one device-to-host read per call)."""
    return bool(CH.chainable(g, edge_mask, loop_cap=loop_cap, order=order))


def auto_backend(g: PoseGraph, edge_mask: torch.Tensor | None = None,
                 loop_cap: int = 64, order: torch.Tensor | None = None,
                 chol: bool = False) -> torch.Tensor:
    """Which backend :func:`optimize_auto` takes on this graph — ``0``
    dense, ``1`` chain+Woodbury, ``2`` PCG (an int32 device scalar)."""
    n = g.poses.shape[-2]
    dev = g.poses.device
    if n > PCG_MIN:
        return torch.full((), 2, dtype=torch.int32, device=dev)
    if n <= _dense_max(chol):
        return torch.zeros((), dtype=torch.int32, device=dev)
    ok = CH.chainable(g, edge_mask, loop_cap=loop_cap, order=order)
    return torch.where(ok, 1, 2).to(torch.int32)


def optimize_auto(g: PoseGraph, iterations: int = 5,
                  edge_mask: torch.Tensor | None = None,
                  loop_cap: int = 64, order: torch.Tensor | None = None,
                  pcg_iters: int = 96, chain_cg_iters: int = 48,
                  chain_cg_tol: float = 1e-6,
                  chol: bool = False) -> PoseGraph:
    """``optimize`` with the capacity-banded backend: dense up to
    ``DENSE_MAX`` (``DENSE_MAX_CHOL`` with ``chol``); above it the chain
    band where :func:`solver.chain.chainable` holds and PCG otherwise;
    PCG above ``PCG_MIN``. ``order`` is the (owner, keyframe) slot
    permutation of merged multi-robot graphs."""
    n = g.poses.shape[-2]
    if n > PCG_MIN:
        BAND_CALLS["optimize_auto", "pcg"] += 1
        return optimize_pcg(g, iterations=iterations, edge_mask=edge_mask,
                            cg_iters=pcg_iters, order=order)
    if n <= _dense_max(chol):
        BAND_CALLS["optimize_auto", "dense"] += 1
        return optimize(g, iterations, edge_mask, chol=chol)
    if _chainable(g, edge_mask, loop_cap, order):
        BAND_CALLS["optimize_auto", "chain"] += 1
        return CH.optimize_chain(g, iterations=iterations,
                                 edge_mask=edge_mask, loop_cap=loop_cap,
                                 order=order, cg_iters=chain_cg_iters,
                                 cg_tol=chain_cg_tol)
    BAND_CALLS["optimize_auto", "pcg"] += 1
    return optimize_pcg(g, iterations=iterations, edge_mask=edge_mask,
                        cg_iters=pcg_iters, order=order)


def marginal_covariance_auto(g: PoseGraph, query: torch.Tensor,
                             edge_mask: torch.Tensor | None = None,
                             loop_cap: int = 64,
                             order: torch.Tensor | None = None,
                             chain_cg_iters: int = 64,
                             chain_cg_tol: float = 1e-5,
                             pcg_cg_iters: int = 160,
                             chol: bool = False) -> torch.Tensor:
    """``marginal_covariance`` with the same banding as
    :func:`optimize_auto` (chain-preconditioned CG column solves above the
    dense band, matrix-free PCG where the graph is not chainable)."""
    n = g.poses.shape[-2]
    if n <= _dense_max(chol):
        BAND_CALLS["marginal_covariance_auto", "dense"] += 1
        return marginal_covariance(g, query, edge_mask, chol=chol)
    if _chainable(g, edge_mask, loop_cap, order):
        BAND_CALLS["marginal_covariance_auto", "chain"] += 1
        return CH.marginal_covariance_chain(g, query, edge_mask,
                                            loop_cap=loop_cap, order=order,
                                            cg_iters=chain_cg_iters,
                                            cg_tol=chain_cg_tol)
    BAND_CALLS["marginal_covariance_auto", "pcg"] += 1
    return marginal_covariance_pcg(g, query, edge_mask,
                                   cg_iters=pcg_cg_iters, order=order)


def marginal_covariance(g: PoseGraph, query: torch.Tensor,
                        edge_mask: torch.Tensor | None = None,
                        chol: bool = False) -> torch.Tensor:
    """Marginal 3×3 covariance blocks ``[Q, 3, 3]`` of the queried vertices
    ``query [Q]`` under the current linearization and gauge (g2o
    ``computeMarginals``): the queried columns of H⁻¹, by one Cholesky
    factorization (``chol``) or by the SPD inverse refined with the dense
    CG polish."""
    eq = build_normal_equations(g, edge_mask)
    H, _ = _gauge_fix(eq.H, eq.b, eq.free3)
    # tiny jitter keeps H invertible for degenerate caller input
    n3 = H.shape[0]
    H = H + 1e-6 * torch.eye(n3, dtype=H.dtype, device=H.device)
    dev = H.device
    cols = (3 * query.long())[:, None] + torch.arange(3, device=dev)[None]
    q = query.shape[0]
    rhs = torch.zeros((n3, 3 * q), dtype=H.dtype, device=dev)
    rhs[cols.reshape(-1), torch.arange(3 * q, device=dev)] = torch.ones(
        (), dtype=H.dtype, device=dev)
    if chol:
        X = torch.cholesky_solve(rhs, _cholesky(H))         # [3N, 3Q]
    else:
        X = pcg_refine(H, rhs, spd_inverse(H))
    Xq = X[cols.reshape(-1)].reshape(q, 3, q, 3)
    ar = torch.arange(q, device=dev)
    return Xq[ar, :, ar, :]                                # [Q,3,3]
