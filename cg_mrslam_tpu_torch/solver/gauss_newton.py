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
:func:`optimize_lm` (Levenberg–Marquardt) damps the dense solve with λ.

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

**Batches of graphs.** Every entry point also takes a graph with a leading
batch axis (poses ``[B, N, 3]``, the layout of ``sim/graphs.build_batch``):
the reference ``vmap``s these functions over such a batch. The dense band
assembles ``[B, 3N, 3N]`` by batched one-hot products
(:func:`batched_normal_eq`), solves by batched Cholesky or by the SPD
inverse and CG polish with one exit per graph. The ``*_auto`` entry points
read the per-graph chain predicate once for the whole batch, run each band
on the sub-batch that takes it and put the results back in batch order
(what ``vmap`` of the reference's ``lax.cond`` computes). Batch-1 calls
keep their own code and bits.

The reference's ``CG_MRSLAM_CHOLESKY`` environment switch has no
counterpart: callers pass ``chol``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.core.graph import PoseGraph, degrees, unpack_info
from cg_mrslam_tpu_torch.core.linearize import chi2, linearize
from cg_mrslam_tpu_torch.solver import chain as CH
from cg_mrslam_tpu_torch.solver.pcg import (marginal_covariance_pcg,
                                            optimize_pcg)
from cg_mrslam_tpu_torch.solver.spd import pcg_refine, spd_inverse
from cg_mrslam_tpu_torch.utils import se2
from cg_mrslam_tpu_torch.utils.metrics import count, span

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
    deg = degrees(g.e_ij, edge_mask, g.poses.shape[-2])
    return g.vmask & ~g.fixed & (deg > 0)


def batched_normal_eq(poses, e_ij, e_z, e_info, mask):
    """H ``[B, 3N, 3N]``, b ``[B, 3N]`` and degrees ``[B, N]`` of a batch
    over the edges of ``mask`` (``sharding`` passes one edge shard), every
    block summed by batched products with the one-hot endpoint matrices (a
    fixed order)."""
    bl, n = poses.shape[:2]
    el = e_ij.shape[1]
    dt = poses.dtype
    e, Ji, Jj = linearize(poses, e_ij, e_z)
    omega = unpack_info(e_info) * mask.to(dt)[..., None, None]
    JiT_O = Ji.transpose(-1, -2) @ omega
    JjT_O = Jj.transpose(-1, -2) @ omega
    Hii, Hij, Hjj = JiT_O @ Ji, JiT_O @ Jj, JjT_O @ Jj
    bi = (JiT_O @ e[..., None])[..., 0]
    bj = (JjT_O @ e[..., None])[..., 0]
    ar = torch.arange(n, device=poses.device)
    oi = (e_ij[..., 0, None] == ar).to(dt)                     # [B,E,N]
    oj = (e_ij[..., 1, None] == ar).to(dt)
    oiT, ojT = oi.transpose(1, 2), oj.transpose(1, 2)
    diag = (oiT @ Hii.reshape(bl, el, 9)
            + ojT @ Hjj.reshape(bl, el, 9)).reshape(bl, n, 3, 3)
    off = (oiT @ (Hij.reshape(bl, el, 9, 1) * oj[:, :, None, :]).reshape(
        bl, el, 9 * n)).reshape(bl, n, 3, 3, n).permute(0, 1, 2, 4, 3)
    H4 = off + off.permute(0, 3, 4, 1, 2)                     # [B,a,i,b,j]
    H4 = H4 + diag[:, :, :, None, :] * torch.eye(
        n, dtype=dt, device=poses.device)[None, :, None, :, None]
    H = H4.reshape(bl, 3 * n, 3 * n)
    b = (oiT @ bi + ojT @ bj).reshape(bl, 3 * n)
    return H, b, degrees(e_ij, mask, n)


def build_normal_equations(g: PoseGraph,
                           edge_mask: torch.Tensor | None = None
                           ) -> NormalEq:
    """Assemble H = Σ JᵀΩJ and b = Σ JᵀΩe over active edges: the four 3×3
    blocks of every edge summed into an ``[N, 3, N, 3]`` block array by
    one-hot products (a fixed order; bit-identical on repeat). A batch
    gives ``[B, 3N, 3N]``."""
    n = g.poses.shape[-2]
    dt = g.poses.dtype
    emask_b = g.emask if edge_mask is None else edge_mask
    if g.poses.dim() == 3:
        H, bv, deg = batched_normal_eq(g.poses, g.e_ij, g.e_z, g.e_info,
                                       emask_b)
        free = g.vmask & ~g.fixed & (deg > 0)
        return NormalEq(H=H, b=bv, free3=torch.repeat_interleave(
            free, 3, dim=-1).to(dt))
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
    Hf = H * free3[..., :, None] * free3[..., None, :]
    Hf = Hf + torch.diag_embed(1.0 - free3)
    return Hf, b * free3


def _cholesky(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``H`` (or of each matrix of a batch); NaN
    (not an exception, not a host sync) where a matrix is not positive
    definite — ``cho_factor``'s behaviour."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def solve_normal_equations(eq: NormalEq,
                           damping: torch.Tensor | float = 0.0,
                           chol: bool = False) -> torch.Tensor:
    """dx = -(H + λ·diag(free))⁻¹ b; λ = 0 is pure Gauss–Newton. ``chol``
    factorizes (the batch-1 live path); otherwise the explicit SPD inverse
    (``solver.spd``) preconditions and warm-starts a dense CG polish (the
    reference's default). A damping given as the Python number 0 adds
    nothing (the reference adds exact zeros): the live path's operations
    and bits stay as they were."""
    H, b = _gauge_fix(eq.H, eq.b, eq.free3)
    bd = H.dim() - 2
    if isinstance(damping, torch.Tensor) or damping != 0.0:
        lam = torch.as_tensor(damping, dtype=H.dtype, device=H.device)
        H = H + torch.diag_embed(lam * eq.free3)
    if chol:
        dx = -torch.cholesky_solve(b[..., None], _cholesky(H))[..., 0]
    else:
        dx = -pcg_refine(H, b[..., None], spd_inverse(H, batch_dims=bd),
                         batch_dims=bd)[..., 0]
    return dx * eq.free3


def gn_step(g: PoseGraph, edge_mask: torch.Tensor | None = None,
            damping: torch.Tensor | float = 0.0,
            chol: bool = False) -> PoseGraph:
    """One linearize → solve → oplus update (g2o GN iteration); ``damping``
    is the Levenberg–Marquardt λ."""
    with span("gn.linearize"):
        eq = build_normal_equations(g, edge_mask)
    with span("gn.solve"):
        dx = solve_normal_equations(eq, damping, chol=chol)
    with span("gn.update"):
        g = dataclasses.replace(g, poses=se2.oplus(g.poses,
                                                   dx.reshape(g.poses.shape)))
    count("gn.iters.dense")
    return g


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
    bd = g.poses.dim() - 2
    for _ in range(iterations):
        with span("gn.linearize"):
            eq = build_normal_equations(g, edge_mask)
        with span("gn.solve"):
            H, b = _gauge_fix(eq.H, eq.b, eq.free3)
            if minv is None:
                minv = spd_inverse(H, batch_dims=bd)
            dx = -pcg_refine(H, b[..., None], minv, tol=1e-7,
                             batch_dims=bd)[..., 0] * eq.free3
        with span("gn.update"):
            g = dataclasses.replace(g, poses=se2.oplus(
                g.poses, dx.reshape(g.poses.shape)))
        count("gn.iters.dense")
    return g


def _dense_max(chol: bool) -> int:
    return DENSE_MAX_CHOL if chol else DENSE_MAX


def _chainable(g, edge_mask, loop_cap, order) -> bool:
    """The chain band's runtime check, read on the host: the reference's
    ``lax.cond`` predicate (one device-to-host read per call)."""
    count("host_read.chainable")
    return bool(CH.chainable(g, edge_mask, loop_cap=loop_cap, order=order))


def _take(g: PoseGraph, idx: torch.Tensor) -> PoseGraph:
    """The graphs ``idx`` of a batch."""
    return PoseGraph(**{f.name: getattr(g, f.name)[idx]
                        for f in dataclasses.fields(g)})


def _split_bands(g, edge_mask, loop_cap, order, entry, chain_fn, pcg_fn,
                 out_like, spans="band."):
    """Each graph of a batch through the chain band where it is chainable
    and PCG where it is not: one host read of the per-graph predicate for
    the whole batch, each band run on its sub-batch (under the span
    ``spans`` + the band's name), the results put back in batch order in a
    tensor like ``out_like`` ``[B, ...]``."""
    with span("solver.split"):
        ok = CH.chainable(g, edge_mask, loop_cap=loop_cap,
                          order=order).cpu()
        count("host_read.split")
        out = torch.empty_like(out_like)
        for band, fn, sel in (("chain", chain_fn, ok), ("pcg", pcg_fn, ~ok)):
            idx = torch.nonzero(sel).reshape(-1).to(out.device)
            if idx.numel():
                BAND_CALLS[entry, band] += idx.numel()
                em = edge_mask if edge_mask is None else edge_mask[idx]
                sub = _take(g, idx)
                with span(spans + band):
                    res = fn(sub, em, idx)
                out[idx] = res
        return out


def auto_backend(g: PoseGraph, edge_mask: torch.Tensor | None = None,
                 loop_cap: int = 64, order: torch.Tensor | None = None,
                 chol: bool = False) -> torch.Tensor:
    """Which backend :func:`optimize_auto` takes on this graph — ``0``
    dense, ``1`` chain+Woodbury, ``2`` PCG (an int32 device scalar; ``[B]``
    for a batch)."""
    n = g.poses.shape[-2]
    dev = g.poses.device
    if n > PCG_MIN:
        return torch.full(g.poses.shape[:-2], 2, dtype=torch.int32,
                          device=dev)
    if n <= _dense_max(chol):
        return torch.zeros(g.poses.shape[:-2], dtype=torch.int32,
                           device=dev)
    ok = CH.chainable(g, edge_mask, loop_cap=loop_cap, order=order)
    return torch.where(ok, 1, 2).to(torch.int32)


def optimize_auto(g: PoseGraph, iterations: int = 5,
                  edge_mask: torch.Tensor | None = None,
                  loop_cap: int = 64, order: torch.Tensor | None = None,
                  pcg_iters: int = 96, chain_cg_iters: int = 48,
                  chain_cg_tol: float = 1e-6,
                  chol: bool = False, pcg_graph: bool = False) -> PoseGraph:
    """``optimize`` with the capacity-banded backend: dense up to
    ``DENSE_MAX`` (``DENSE_MAX_CHOL`` with ``chol``); above it the chain
    band where :func:`solver.chain.chainable` holds and PCG otherwise;
    PCG above ``PCG_MIN``. ``order`` is the (owner, keyframe) slot
    permutation of merged multi-robot graphs (one for every graph of a
    batch). ``pcg_graph``: the PCG band's CG iterations replayed as
    captured CUDA graphs (``pcg.pcg_delta``'s ``cg_graph``)."""
    n = g.poses.shape[-2]
    with span("solver.optimize_auto"):
        if g.poses.dim() == 3 and _dense_max(chol) < n <= PCG_MIN:
            poses = _split_bands(
                g, edge_mask, loop_cap, order, "optimize_auto",
                lambda gs, em, _: CH.optimize_chain(
                    gs, iterations=iterations, edge_mask=em,
                    loop_cap=loop_cap, order=order,
                    cg_iters=chain_cg_iters, cg_tol=chain_cg_tol).poses,
                lambda gs, em, _: optimize_pcg(
                    gs, iterations=iterations, edge_mask=em,
                    cg_iters=pcg_iters, order=order,
                    cg_graph=pcg_graph).poses, g.poses)
            return dataclasses.replace(g, poses=poses)
        if n > PCG_MIN:
            band = "pcg"
        elif n <= _dense_max(chol):
            band = "dense"
        elif _chainable(g, edge_mask, loop_cap, order):
            band = "chain"
        else:
            band = "pcg"
        BAND_CALLS["optimize_auto", band] += 1
        with span("band." + band):
            if band == "dense":
                return optimize(g, iterations, edge_mask, chol=chol)
            if band == "chain":
                return CH.optimize_chain(g, iterations=iterations,
                                         edge_mask=edge_mask,
                                         loop_cap=loop_cap, order=order,
                                         cg_iters=chain_cg_iters,
                                         cg_tol=chain_cg_tol)
            return optimize_pcg(g, iterations=iterations,
                                edge_mask=edge_mask, cg_iters=pcg_iters,
                                order=order, cg_graph=pcg_graph)


def marginal_covariance_auto(g: PoseGraph, query: torch.Tensor,
                             edge_mask: torch.Tensor | None = None,
                             loop_cap: int = 64,
                             order: torch.Tensor | None = None,
                             chain_cg_iters: int = 64,
                             chain_cg_tol: float = 1e-5,
                             pcg_cg_iters: int = 160,
                             chol: bool = False,
                             pcg_graph: bool = False) -> torch.Tensor:
    """``marginal_covariance`` with the same banding as
    :func:`optimize_auto` (chain-preconditioned CG column solves above the
    dense band, matrix-free PCG where the graph is not chainable). A batch
    takes ``query`` ``[Q]`` (every graph) or ``[B, Q]``; its banded
    solves run under the spans ``marginal.chain`` and ``marginal.pcg``
    (not ``band.*``, the optimizations' spans). ``pcg_graph``: as
    :func:`optimize_auto`'s."""
    n = g.poses.shape[-2]
    if g.poses.dim() == 3 and n > _dense_max(chol):
        b = g.poses.shape[0]
        q = query.expand(b, -1) if query.dim() == 1 else query
        like = g.poses.new_empty((b, q.shape[1], 3, 3))
        return _split_bands(
            g, edge_mask, loop_cap, order, "marginal_covariance_auto",
            lambda gs, em, idx: CH.marginal_covariance_chain(
                gs, q[idx], em, loop_cap=loop_cap, order=order,
                cg_iters=chain_cg_iters, cg_tol=chain_cg_tol),
            lambda gs, em, idx: marginal_covariance_pcg(
                gs, q[idx], em, cg_iters=pcg_cg_iters, order=order,
                cg_graph=pcg_graph), like,
            spans="marginal.")
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
                                   cg_iters=pcg_cg_iters, order=order,
                                   cg_graph=pcg_graph)


class LMState(NamedTuple):
    graph: PoseGraph
    lam: torch.Tensor    # [] damping λ
    chi2: torch.Tensor   # [] chi2 of ``graph``
    accept: torch.Tensor  # [] bool — the last trial step was taken


def lm_step(st: LMState, edge_mask: torch.Tensor) -> LMState:
    """One Levenberg–Marquardt iteration: a damped GN trial step (the SPD
    inverse solve, ``chol=False``), taken if it lowers chi2; λ halves on
    acceptance and quadruples on rejection. Everything stays on the
    device (no host read)."""
    trial = gn_step(st.graph, edge_mask, damping=st.lam)
    c_new = chi2(trial, edge_mask)
    accept = c_new < st.chi2
    g = dataclasses.replace(st.graph, poses=torch.where(
        accept, trial.poses, st.graph.poses))
    return LMState(graph=g,
                   lam=torch.where(accept, st.lam * 0.5, st.lam * 4.0),
                   chi2=torch.where(accept, c_new, st.chi2), accept=accept)


def optimize_lm(g: PoseGraph, iterations: int = 10,
                edge_mask: torch.Tensor | None = None,
                init_lambda: float = 1e-4) -> PoseGraph:
    """Levenberg–Marquardt with a multiplicative λ schedule: ``iterations``
    :func:`lm_step` calls (a static loop). A robustness option for poorly
    initialized graphs; not on the live path. A trial changes only the
    poses, so a rejected one keeps the graph as it was."""
    mask = g.emask if edge_mask is None else edge_mask
    st = LMState(graph=g, lam=torch.full((), init_lambda,
                                         dtype=g.poses.dtype,
                                         device=g.poses.device),
                 chi2=chi2(g, mask),
                 accept=torch.zeros((), dtype=torch.bool,
                                    device=g.poses.device))
    for _ in range(iterations):
        st = lm_step(st, mask)
    return st.graph


def marginal_covariance(g: PoseGraph, query: torch.Tensor,
                        edge_mask: torch.Tensor | None = None,
                        chol: bool = False) -> torch.Tensor:
    """Marginal 3×3 covariance blocks ``[Q, 3, 3]`` of the queried vertices
    ``query [Q]`` under the current linearization and gauge (g2o
    ``computeMarginals``): the queried columns of H⁻¹, by one Cholesky
    factorization (``chol``) or by the SPD inverse refined with the dense
    CG polish. A batch takes ``query`` ``[Q]`` (every graph) or ``[B, Q]``
    and gives ``[B, Q, 3, 3]``."""
    if g.poses.dim() == 3:
        return _marginal_covariance_batched(g, query, edge_mask, chol)
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


def _marginal_covariance_batched(g: PoseGraph, query: torch.Tensor,
                                 edge_mask, chol: bool) -> torch.Tensor:
    eq = build_normal_equations(g, edge_mask)
    H, _ = _gauge_fix(eq.H, eq.b, eq.free3)
    b, n3 = H.shape[:2]
    dev = H.device
    H = H + 1e-6 * torch.eye(n3, dtype=H.dtype, device=dev)
    q = (query.expand(b, -1) if query.dim() == 1 else query).long()
    nq = q.shape[1]
    cols = (3 * q[..., None] + torch.arange(3, device=dev)).reshape(b, -1)
    rhs = (torch.arange(n3, device=dev)[None, :, None]
           == cols[:, None, :]).to(H.dtype)                  # [B,3N,3Q]
    if chol:
        X = torch.cholesky_solve(rhs, _cholesky(H))
    else:
        X = pcg_refine(H, rhs, spd_inverse(H, batch_dims=1), batch_dims=1)
    Xq = torch.gather(X, 1, cols[..., None].expand(-1, -1, 3 * nq))
    Xq = Xq.reshape(b, nq, 3, nq, 3)
    return torch.diagonal(Xq, dim1=1, dim2=3).permute(0, 3, 1, 2)
