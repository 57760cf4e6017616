"""Batched SE(2) operations on ``[..., 3]`` tensors ``(x, y, theta)``.

Port of ``cg_mrslam_tpu/utils/se2.py``: every op broadcasts over leading
batch dimensions, angles wrap to (-pi, pi] branch-free.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] as ``theta - 2*pi*round(theta / (2*pi))``
    (g2o ``normalize_theta`` without data-dependent branching)."""
    return theta - TWO_PI * torch.round(theta / TWO_PI)


def cos_sin(theta: torch.Tensor):
    """``cos`` and ``sin`` of float32 angles, computed in float64 and rounded
    to float32. The card's and the CPU's float32 ``sin`` / ``cos`` differ in
    the last bit for 18% / 22% of angles (one H100,
    ``tools/card_cpu_cells.py``), which moves a point next to a cell edge
    into the neighbouring cell on one device only; rounded from float64
    they gave the same bits for all 4,000,000 angles there."""
    t = theta.double()
    return torch.cos(t).to(theta.dtype), torch.sin(t).to(theta.dtype)


def rot(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``[..., 2, 2]`` from angles ``[...]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SE(2) group product ``a ∘ b`` for ``[..., 3]`` poses."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = normalize_angle(a[..., 2] + b[..., 2])
    return torch.stack([x, y, t], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    """SE(2) group inverse for ``[..., 3]`` poses."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], dim=-1)


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a⁻¹ ∘ b`` — the measurement an edge a→b would predict."""
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = ca * dx + sa * dy
    y = -sa * dx + ca * dy
    t = normalize_angle(b[..., 2] - a[..., 2])
    return torch.stack([x, y, t], dim=-1)


def apply(a: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points ``[..., P, 2]`` by poses ``[..., 3]`` (the rotation
    from :func:`cos_sin`: the same world points on the card and the CPU)."""
    ca, sa = cos_sin(a[..., 2])
    px, py = pts[..., 0], pts[..., 1]
    ca, sa = ca[..., None], sa[..., None]
    x = ca * px - sa * py + a[..., 0:1]
    y = sa * px + ca * py + a[..., 1:2]
    return torch.stack([x, y], dim=-1)


def oplus(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """g2o ``VertexSE2::oplusImpl``: additive update in the global frame
    with angle renormalisation (not the SE(2) exp map)."""
    return torch.stack(
        [
            pose[..., 0] + delta[..., 0],
            pose[..., 1] + delta[..., 1],
            normalize_angle(pose[..., 2] + delta[..., 2]),
        ],
        dim=-1,
    )


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(2) exponential map from twist ``(vx, vy, omega)`` to a pose."""
    w = xi[..., 2]
    # Taylor-safe sinc terms
    small = torch.abs(w) < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(ws) / ws)
    b = torch.where(small, w / 2.0, (1.0 - torch.cos(ws)) / ws)
    x = a * xi[..., 0] - b * xi[..., 1]
    y = b * xi[..., 0] + a * xi[..., 1]
    return torch.stack([x, y, normalize_angle(w)], dim=-1)


def log(pose: torch.Tensor) -> torch.Tensor:
    """SE(2) logarithm map, inverse of :func:`exp`."""
    w = pose[..., 2]
    small = torch.abs(w) < 1e-6
    half = torch.where(small, torch.ones_like(w), w) / 2.0
    # V⁻¹ = [[A, B], [-B, A]] with A = (w/2)·cot(w/2), B = w/2
    a = torch.where(small, 1.0 - w * w / 12.0, half / torch.tan(half))
    b = w / 2.0
    vx = a * pose[..., 0] + b * pose[..., 1]
    vy = -b * pose[..., 0] + a * pose[..., 1]
    return torch.stack([vx, vy, normalize_angle(w)], dim=-1)
