"""Plain float64 oracle of a condensed star under the uncertainty-minimizing
gauge: torch only (no ``jax``, nothing of ``cg_mrslam_tpu`` or
``cg_mrslam_tpu_torch``), written from the reference system's semantics
(``CondensedGraphCreator`` + g2o ``EdgeLabeler``, ``selectOptimalGauge``,
``condensed_graph_buffer.cpp:252-288``).

For a graph, its own edges and a boundary, each candidate gauge ``k``:

* re-gauge: ``k`` is the only fixed vertex; the free vertices are the live
  ones an own edge touches, but ``k``;
* one exact Gauss–Newton iteration over the own edges, on the free
  coordinates only (dense ``torch.linalg.solve``);
* at the settled poses, the boundary's marginal covariances
  ``(H_ff + 1e-6·I)⁻¹`` (the identity block for a vertex that is not
  free);
* the label of the virtual edge ``k → v``: ``z = x_k⁻¹ ∘ x_v`` and
  ``Ω = (J Σ Jᵀ + 1e-9·I)⁻¹``, symmetrized, ``J = ∂e/∂x_v`` of the edge's
  error at ``z``;
* the total uncertainty ``Σ det(Ωₑ)⁻¹`` over the valid edges; the first
  minimum wins.

Jacobians come from ``torch.func`` (automatic differentiation of the g2o
``EdgeSE2`` error), not from the hand-derived ones of the code under test.
"""

from __future__ import annotations

import numpy as np
import torch

DT = torch.float64


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _inv_compose(a, b):
    """``a⁻¹ ∘ b`` of two SE(2) poses ``[3]``."""
    c, s = torch.cos(a[2]), torch.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        _wrap(b[2] - a[2])])


def _error(xi, xj, z):
    """g2o ``EdgeSE2``: ``z⁻¹ ∘ (xᵢ⁻¹ ∘ xⱼ)``, the angle wrapped."""
    return _inv_compose(z, _inv_compose(xi, xj))


_JAC = torch.func.vmap(torch.func.jacrev(_error, argnums=(0, 1)))
_ERR = torch.func.vmap(_error)


def _info(p6: torch.Tensor) -> torch.Tensor:
    xx, xy, xt, yy, yt, tt = p6.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xt], -1),
                        torch.stack([xy, yy, yt], -1),
                        torch.stack([xt, yt, tt], -1)], -2)


def _system(poses, e_ij, e_z, omega, free):
    """``H`` and ``b`` over the edges given, restricted to the free
    coordinates: ``(H_ff, b_f, coordinate index of each free vertex)``."""
    n, dev = poses.shape[0], poses.device
    xi, xj = poses[e_ij[:, 0]], poses[e_ij[:, 1]]
    e = _ERR(xi, xj, e_z)
    Ji, Jj = _JAC(xi, xj, e_z)
    H = torch.zeros((n, 3, n, 3), dtype=DT, device=dev)
    b = torch.zeros((n, 3), dtype=DT, device=dev)
    for a, Ja in ((0, Ji), (1, Jj)):
        b.index_put_((e_ij[:, a],), (Ja.transpose(1, 2) @ omega
                                     @ e[..., None])[..., 0],
                     accumulate=True)
        for c, Jc in ((0, Ji), (1, Jj)):
            blk = Ja.transpose(1, 2) @ omega @ Jc
            for r in range(3):
                for s in range(3):
                    H[:, r, :, s].index_put_((e_ij[:, a], e_ij[:, c]),
                                             blk[:, r, s], accumulate=True)
    idx = torch.nonzero(free).reshape(-1)
    cols = (3 * idx[:, None] + torch.arange(3, device=dev)).reshape(-1)
    H = H.reshape(3 * n, 3 * n)[cols][:, cols]
    return H, b.reshape(-1)[cols], idx


def star(g: dict, own: np.ndarray, boundary: np.ndarray,
         bvalid: np.ndarray, gauge: int, device="cpu"):
    """The star of one graph (``poses [N,3]``, ``vmask``, ``e_ij``,
    ``e_z``, ``e_info``; NumPy) at the gauge vertex ``gauge``, computed on
    ``device``: ``(z [K,3], omega [K,3,3], valid [K])``, float64 NumPy."""
    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    poses = t(g["poses"], DT)
    n = poses.shape[0]
    act = t(own, torch.bool)
    e_ij = t(g["e_ij"]).long()[act]
    e_z = t(g["e_z"], DT)[act]
    omega = _info(t(g["e_info"], DT)[act])
    touched = torch.zeros(n, dtype=torch.bool, device=device)
    touched[e_ij.reshape(-1)] = True
    free = (t(g["vmask"]) & touched
            & (torch.arange(n, device=device) != gauge))
    # one exact Gauss–Newton iteration
    H, b, idx = _system(poses, e_ij, e_z, omega, free)
    dx = torch.linalg.solve(H, -b).reshape(-1, 3)
    poses = poses.clone()
    poses[idx, :2] += dx[:, :2]
    poses[idx, 2] = _wrap(poses[idx, 2] + dx[:, 2])
    # the boundary's marginals at the settled poses
    H, _, idx = _system(poses, e_ij, e_z, omega, free)
    eye = torch.eye(3, dtype=DT, device=device)
    H = H + 1e-6 * torch.eye(H.shape[0], dtype=DT, device=device)
    where = torch.full((n,), -1, dtype=torch.long, device=device)
    where[idx] = torch.arange(idx.numel(), device=device)
    bt = t(boundary).long()
    k = bt.shape[0]
    sig = eye.repeat(k, 1, 1)
    at = where[bt]
    fr = torch.nonzero(at >= 0).reshape(-1)
    if fr.numel():
        cols = (3 * at[fr][:, None]
                + torch.arange(3, device=device)).reshape(-1)
        rhs = torch.zeros((H.shape[0], cols.numel()), dtype=DT,
                          device=device)
        rhs[cols, torch.arange(cols.numel(), device=device)] = 1.0
        X = torch.linalg.solve(H, rhs)[cols]
        X = X.reshape(fr.numel(), 3, fr.numel(), 3)
        ar = torch.arange(fr.numel(), device=device)
        sig[fr] = X[ar, :, ar, :]
    sig = 0.5 * (sig + sig.transpose(1, 2))
    # the labels
    xg = poses[gauge].expand(k, 3)
    xv = poses[bt]
    z = torch.stack([_inv_compose(a, c) for a, c in zip(xg, xv)])
    _, J = _JAC(xg, xv, z)
    cov = J @ sig @ J.transpose(1, 2)
    cov = 0.5 * (cov + cov.transpose(1, 2)) + 1e-9 * eye
    om = torch.linalg.inv(cov)
    om = 0.5 * (om + om.transpose(1, 2))
    valid = np.asarray(bvalid) & (np.asarray(boundary) != gauge)
    return z.cpu().numpy(), om.cpu().numpy(), valid


def optimal(g: dict, own: np.ndarray, boundary: np.ndarray,
            bvalid: np.ndarray, device="cpu"):
    """Every candidate's total uncertainty ``u [K]`` (+inf on an invalid
    slot), the winning slot (the first minimum) and its star ``(z, omega,
    valid)``, computed on ``device``."""
    k = len(boundary)
    u = np.full(k, np.inf)
    stars = {}
    for i in np.flatnonzero(bvalid):
        z, om, va = stars[i] = star(g, own, boundary, bvalid,
                                    int(boundary[i]), device)
        inv = 1.0 / np.maximum(np.linalg.det(om), 1e-30)
        u[i] = np.sum(np.where(va, inv, 0.0))
    best = int(np.argmin(u))
    if best not in stars:
        stars[best] = star(g, own, boundary, bvalid, int(boundary[best]),
                           device)
    return u, best, stars[best]
