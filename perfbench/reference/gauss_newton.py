"""Plain Gauss–Newton over SE(2) pose graphs: the benchmark's reference.

The semantics of the reference system's ``optimize(n)``
(``graph_slam.cpp:561-574``, g2o's ``OptimizationAlgorithmGaussNewton``
over ``EdgeSE2``): ``n`` iterations of

* the error of edge ``i → j`` with measurement ``z``:
  ``e = z⁻¹ ∘ (xᵢ⁻¹ ∘ xⱼ)``, its angle wrapped to (-π, π];
* its analytic Jacobians in the additive chart of ``VertexSE2::oplus``;
* ``H = Σ JᵀΩJ``, ``b = Σ JᵀΩe`` over the live edges, as one dense matrix;
* the gauge: vertices that are not live, fixed, or touched by no live
  edge keep their pose (their rows become the identity);
* ``dx = -H⁻¹ b`` by a dense LU factorization with partial pivoting,
  exact (it stays finite where rounding leaves ``H`` indefinite);
* ``x ← x ⊕ dx`` (translation added, angle added and wrapped).

Plain PyTorch, written from those equations: rotations as 2×2 matrices,
blocks scattered into ``H`` by index. It imports nothing of the program and
takes only the graphs the benchmark made. It runs in float64 on whatever
device it is given, a block of graphs at a time.

``tf32=True`` computes it one precision below float32 with TF32 off: in
float32, with every operand of every matrix product rounded to TF32 (ten
mantissa bits, round to nearest even) and the products accumulated in
float32, as the tensor cores do in TF32. The rounding is done here, and not
left to ``torch.backends.cuda.matmul.allow_tf32``, because the library may
keep a 3×3 product off the tensor cores; this way the control computes in
TF32 on every device. The factorization stays in float32.
"""

from __future__ import annotations

import math

import torch

FIELDS = ("poses", "vmask", "fixed", "e_ij", "e_z", "e_info", "emask")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's ten mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0x0FFF + lsb) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


class _Arith:
    """Matrix products in the reference's precision."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b


def wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def rotation(th: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def information(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., 6]`` (xx xy xt yy yt tt) → symmetric ``[..., 3, 3]``."""
    xx, xy, xt, yy, yt, tt = packed.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xt], -1),
                        torch.stack([xy, yy, yt], -1),
                        torch.stack([xt, yt, tt], -1)], -2)


def edges(poses, e_ij, e_z, ar: _Arith):
    """Errors ``[S, E, 3]`` and Jacobians ``[S, E, 3, 3]`` w.r.t. ``xᵢ``,
    ``xⱼ`` of every edge slot."""
    ii = e_ij[..., 0].long()
    jj = e_ij[..., 1].long()
    xi = torch.gather(poses, 1, ii[..., None].expand(-1, -1, 3))
    xj = torch.gather(poses, 1, jj[..., None].expand(-1, -1, 3))
    RiT = rotation(xi[..., 2]).transpose(-1, -2)
    RzT = rotation(e_z[..., 2]).transpose(-1, -2)
    d = (xj[..., :2] - xi[..., :2])[..., None]                 # [S,E,2,1]
    A = ar.mm(RzT, RiT)                                       # Rzᵀ Rᵢᵀ
    et = ar.mm(RzT, ar.mm(RiT, d) - e_z[..., :2, None])[..., 0]
    eth = wrap(xj[..., 2] - xi[..., 2] - e_z[..., 2])
    e = torch.cat([et, eth[..., None]], -1)
    c, s = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    dRiT = torch.stack([torch.stack([-s, c], -1),
                        torch.stack([-c, -s], -1)], -2)       # ∂Rᵢᵀ/∂θᵢ
    dth = ar.mm(RzT, ar.mm(dRiT, d))[..., 0]                  # [S,E,2]
    shape = e.shape[:-1]
    Ji = poses.new_zeros(shape + (3, 3))
    Jj = poses.new_zeros(shape + (3, 3))
    Ji[..., :2, :2] = -A
    Ji[..., :2, 2] = dth
    Ji[..., 2, 2] = -1.0
    Jj[..., :2, :2] = A
    Jj[..., 2, 2] = 1.0
    return e, Ji, Jj


def normal_equations(g: dict, ar: _Arith):
    """``H [S, 3N, 3N]`` and ``b [S, 3N]`` with the gauge applied, and the
    free-coordinate mask ``f3 [S, 3N]``."""
    poses = g["poses"]
    s, n = poses.shape[:2]
    dt, dev = poses.dtype, poses.device
    live = g["emask"]
    e, Ji, Jj = edges(poses, g["e_ij"], g["e_z"], ar)
    om = information(g["e_info"]) * live.to(dt)[..., None, None]
    JiT_O = ar.mm(Ji.transpose(-1, -2), om)
    JjT_O = ar.mm(Jj.transpose(-1, -2), om)
    Hij = ar.mm(JiT_O, Jj)
    blocks = {(0, 0): ar.mm(JiT_O, Ji), (0, 1): Hij,
              (1, 0): Hij.transpose(-1, -2), (1, 1): ar.mm(JjT_O, Jj)}
    grads = (ar.mm(JiT_O, e[..., None])[..., 0],
             ar.mm(JjT_O, e[..., None])[..., 0])
    ends = (g["e_ij"][..., 0].long(), g["e_ij"][..., 1].long())
    m = 3 * n
    H = torch.zeros((s, m * m), dtype=dt, device=dev)
    bvec = torch.zeros((s, m), dtype=dt, device=dev)
    for (a, c), blk in blocks.items():
        H.scatter_add_(1, _block_index(ends[a], ends[c], m),
                       blk.reshape(s, -1))
    k3 = torch.arange(3, device=dev)
    for a in (0, 1):
        idx = (3 * ends[a][..., None] + k3).reshape(s, -1)
        bvec.scatter_add_(1, idx, grads[a].reshape(s, -1))
    H = H.reshape(s, m, m)
    deg = torch.zeros((s, n), dtype=torch.int64, device=dev)
    one = live.to(torch.int64)
    deg.scatter_add_(1, ends[0], one)
    deg.scatter_add_(1, ends[1], one)
    free = g["vmask"] & ~g["fixed"] & (deg > 0)
    f3 = free.repeat_interleave(3, dim=1).to(dt)
    H = H * f3[:, :, None] * f3[:, None, :] + torch.diag_embed(1.0 - f3)
    return H, bvec * f3, f3


def _block_index(rows: torch.Tensor, cols: torch.Tensor, m: int):
    """Flat indices into a ``[S, m·m]`` matrix of the 3×3 block of every
    edge at block row ``rows [S, E]`` and block column ``cols [S, E]``."""
    k3 = torch.arange(3, device=rows.device)
    r = 3 * rows[..., None, None] + k3[:, None]
    c = 3 * cols[..., None, None] + k3[None, :]
    return (r * m + c).reshape(rows.shape[0], -1)


def lu_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``A⁻¹ rhs`` of each system of a batch by LU with partial pivoting,
    one system at a time (batched LU is far slower on some CPU builds)."""
    return torch.stack([torch.linalg.solve(a, r) for a, r in zip(A, rhs)])


def step(g: dict, ar: _Arith) -> torch.Tensor:
    """One Gauss–Newton iteration: the new poses ``[S, N, 3]``."""
    poses = g["poses"]
    s, n = poses.shape[:2]
    H, rhs, f3 = normal_equations(g, ar)
    dx = (-lu_solve(H, rhs) * f3).reshape(s, n, 3)
    return torch.cat([poses[..., :2] + dx[..., :2],
                      wrap(poses[..., 2:] + dx[..., 2:])], -1)


def optimize(graphs: dict, iterations: int = 5, device="cpu",
             tf32: bool = False, block: int = 16) -> torch.Tensor:
    """``iterations`` Gauss–Newton iterations of every graph of
    ``graphs`` (NumPy arrays or tensors with a leading batch axis, the
    fields of :data:`FIELDS`), ``block`` graphs at a time. Returns the
    poses ``[S, N, 3]`` in float64 on the CPU."""
    dt = torch.float32 if tf32 else torch.float64
    ar = _Arith(tf32)
    total = graphs["poses"].shape[0]
    out = []
    for lo in range(0, total, block):
        g = {}
        for k in FIELDS:
            t = torch.as_tensor(graphs[k][lo:lo + block]).to(device)
            g[k] = t.to(dt) if t.is_floating_point() else t
        for _ in range(iterations):
            g["poses"] = step(g, ar)
        out.append(g["poses"].double().cpu())
    return torch.cat(out)
