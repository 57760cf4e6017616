"""Plain condensed stars under the uncertainty-minimizing gauge: the
benchmark's reference for a robot's answer to a peer's request.

The semantics of the reference system's ``selectOptimalGauge``
(``condensed_graph_buffer.cpp:252-288``) over its ``CondensedGraphCreator``
and g2o's ``EdgeLabeler``. For one graph, its own edges and a boundary of
``K`` vertices, each valid boundary vertex ``k`` in turn is the gauge:

* re-gauge: ``k`` is the only fixed vertex; the free vertices are the live
  vertices that an own edge touches, but ``k``;
* one exact Gauss–Newton iteration over the own edges
  (``reference/gauss_newton.step``: dense LU);
* the marginal covariance of every boundary vertex conditioned on ``k``:
  the columns of ``(H + 1e-6·I)⁻¹`` over the free coordinates, ``H`` at the
  settled poses, and the identity block for a boundary vertex that is not
  free;
* the label of the virtual edge ``k → v``: ``z = x_k⁻¹ ∘ x_v`` and
  ``Ω = (J Σ Jᵀ + 1e-9·I)⁻¹`` symmetrized, ``J`` the Jacobian of the edge's
  error with respect to ``x_v`` at ``z``; the edge is valid where ``v`` is a
  valid slot other than ``k``;
* the total uncertainty ``Σ det(Ωₑ)⁻¹`` over the star's valid edges.

The gauge is the first minimum of the total uncertainties. Plain PyTorch,
written from those steps; it imports nothing of the program. It runs in
float64 on whatever device it is given, ``block`` candidates at a time, or
with ``tf32=True`` one precision below float32 (``reference/gauss_newton``'s
TF32 rounding of every matrix product's operands).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import gauss_newton as gnr

JITTER_MARGINAL = 1e-6
JITTER_LABEL = 1e-9


def relative(a: torch.Tensor, b: torch.Tensor, ar) -> torch.Tensor:
    """``a⁻¹ ∘ b`` for ``a [S, 3]`` and ``b [S, K, 3]``: ``[S, K, 3]``."""
    RaT = gnr.rotation(a[:, 2]).transpose(-1, -2)[:, None]
    d = (b[..., :2] - a[:, None, :2])[..., None]
    t = ar.mm(RaT, d)[..., 0]
    return torch.cat([t, gnr.wrap(b[..., 2] - a[:, None, 2])[..., None]],
                     -1)


def candidates(g: dict, own: torch.Tensor, boundary: torch.Tensor,
               bvalid: torch.Tensor, gauges: torch.Tensor, ar):
    """The stars of one graph ``g`` (tensors without a batch axis) at the
    gauges ``gauges [C]`` (boundary vertices): ``(u [C], z [C, K, 3],
    omega [C, K, 3, 3], valid [C, K])``."""
    c = gauges.shape[0]
    n = g["poses"].shape[0]
    k = boundary.shape[0]
    dev, dt = g["poses"].device, g["poses"].dtype
    gb = {f: g[f].expand((c,) + g[f].shape) for f in gnr.FIELDS}
    gb["emask"] = own.expand(c, -1)
    gb["fixed"] = torch.arange(n, device=dev) == gauges[:, None]
    gb["poses"] = gnr.step(gb, ar)
    H, _, f3 = gnr.normal_equations(gb, ar)
    H = H + torch.diag_embed(JITTER_MARGINAL * f3)
    cols = (3 * boundary[:, None] + torch.arange(3, device=dev)).reshape(-1)
    rhs = torch.zeros((c, 3 * n, 3 * k), dtype=dt, device=dev)
    rhs[:, cols, torch.arange(3 * k, device=dev)] = 1.0
    rhs = rhs * f3[..., None]
    X = gnr.lu_solve(H, rhs)[:, cols]                        # [C, 3K, 3K]
    sig = torch.diagonal(X.reshape(c, k, 3, k, 3), dim1=1,
                         dim2=3).permute(0, 3, 1, 2)         # [C, K, 3, 3]
    free = f3.reshape(c, n, 3)[..., 0] > 0
    eye = torch.eye(3, dtype=dt, device=dev)
    sig = torch.where(free[:, boundary][..., None, None], sig, eye)
    sig = 0.5 * (sig + sig.transpose(-1, -2))

    poses = gb["poses"]
    z = relative(poses[torch.arange(c, device=dev), gauges],
                 poses[:, boundary], ar)
    e_ij = torch.stack([gauges[:, None].expand(c, k),
                        boundary.expand(c, k)], -1)
    _, _, Jb = gnr.edges(poses, e_ij, z, ar)
    cov = ar.mm(ar.mm(Jb, sig), Jb.transpose(-1, -2))
    cov = 0.5 * (cov + cov.transpose(-1, -2)) + JITTER_LABEL * eye
    omega = torch.linalg.inv(cov)
    omega = 0.5 * (omega + omega.transpose(-1, -2))
    valid = bvalid & (boundary != gauges[:, None])
    inv = 1.0 / torch.clamp(torch.linalg.det(omega), min=1e-30)
    u = torch.sum(torch.where(valid, inv, torch.zeros_like(inv)), dim=-1)
    return u, z, omega, valid


def stars(graphs: dict, own: np.ndarray, boundary: np.ndarray,
          bvalid: np.ndarray, device="cpu", tf32: bool = False,
          block: int = 8) -> dict:
    """The optimal-gauge star of every graph of ``graphs`` (NumPy arrays
    with a leading axis ``S``, the fields of ``gauss_newton.FIELDS``), its
    own edges ``own [S, E]``, the boundary ``boundary [K]`` with
    ``bvalid [K]``. Returns float64 NumPy arrays: every candidate's total
    uncertainty ``u [S, K]`` (+inf on an invalid slot), the chosen gauge's
    slot ``gauge [S]``, every candidate's star ``z_all [S, K, K, 3]``,
    ``omega_all [S, K, K, 3, 3]``, ``valid_all [S, K, K]``, and the chosen
    star ``z``, ``omega``, ``valid``."""
    dt = torch.float32 if tf32 else torch.float64
    ar = gnr._Arith(tf32)
    s, k = graphs["poses"].shape[0], len(boundary)
    bt = torch.as_tensor(boundary).long().to(device)
    bv = torch.as_tensor(bvalid).to(device)
    cand = np.flatnonzero(bvalid)
    out = {"u": np.full((s, k), np.inf),
           "z_all": np.zeros((s, k, k, 3)),
           "omega_all": np.zeros((s, k, k, 3, 3)),
           "valid_all": np.zeros((s, k, k), bool)}
    for i in range(s):
        g = {}
        for f in gnr.FIELDS:
            t = torch.as_tensor(graphs[f][i]).to(device)
            g[f] = t.to(dt) if t.is_floating_point() else t
        ow = torch.as_tensor(own[i]).to(device)
        for lo in range(0, len(cand), block):
            sel = cand[lo:lo + block]
            u, z, om, va = candidates(g, ow, bt, bv, bt[sel], ar)
            out["u"][i, sel] = u.double().cpu().numpy()
            out["z_all"][i, sel] = z.double().cpu().numpy()
            out["omega_all"][i, sel] = om.double().cpu().numpy()
            out["valid_all"][i, sel] = va.cpu().numpy()
    # the first minimum (an empty boundary: the first slot)
    out["gauge"] = np.argmin(out["u"], axis=1)
    pick = np.arange(s), out["gauge"]
    for f in ("z", "omega", "valid"):
        out[f] = out[f + "_all"][pick]
    return out
