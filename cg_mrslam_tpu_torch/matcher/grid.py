"""Distance-field grid construction for correlative scan matching.

Port of ``cg_mrslam_tpu/matcher/grid.py`` (the reference's ``CharGrid``
rasterization): a float32 field

    grid[cell] = min(kernel_radius, dist(cell, nearest reference point))

computed as a separable capped Euclidean distance transform. Geometry:
``grid[iy, ix]`` covers world point
``center + (ix + 0.5 - C/2, iy + 0.5 - C/2) * resolution`` (row = y).
:func:`build_grids` builds a batch of grids, one per (points, center)
pair, in one pass.
"""

from __future__ import annotations

import math

import torch


def world_to_cell(points: torch.Tensor, center: torch.Tensor, cells: int,
                  resolution: float) -> torch.Tensor:
    """World ``[..., 2]`` → integer cell indices ``[..., 2]`` as (ix, iy)."""
    rel = over(points - center, resolution) + cells / 2.0
    return torch.floor(rel).to(torch.int32)


def over(x: torch.Tensor, resolution: float) -> torch.Tensor:
    """``x / resolution`` as the CPU divides, on either device, so that a
    point lands in the same cell on the card as on the CPU: the divisor is
    a device tensor. (PyTorch's CUDA division by a Python number multiplies
    by its reciprocal: on one H100 it differed from the CPU's quotient for
    13% of random values and moved all 287 edge points of the card test
    into the neighbouring cell; ``tools/card_cpu_cells.py``.)"""
    return x / torch.full((), resolution, dtype=x.dtype, device=x.device)


def _kernel_patch(kernel_radius: float, resolution: float, device=None):
    """Radial distance patch ``[K, K]`` with values min(r, d), and the
    patch half-width in cells."""
    r_cells = max(1, int(math.ceil(kernel_radius / resolution - 1e-9)))
    k = 2 * r_cells + 1
    off = torch.arange(k, dtype=torch.float32, device=device) - r_cells
    d = torch.sqrt(off[:, None] ** 2 + off[None, :] ** 2) * resolution
    return torch.clamp(d, max=kernel_radius), r_cells


def subsample(points: torch.Tensor, valid: torch.Tensor,
              center: torch.Tensor, *, cells: int,
              resolution: float) -> torch.Tensor:
    """Keep ≤1 point per grid cell: a reduced valid mask (reference
    ``CharGrid::subsample``). Of the points that share a cell the first in
    input order is kept (a stable sort by cell id, as ``jnp.argsort``);
    cell ids are not clipped to the grid, and a negative id is dropped with
    the invalid points, as in the reference."""
    cell = world_to_cell(points, center, cells, resolution)
    cid = torch.where(valid, cell[:, 1] * cells + cell[:, 0],
                      torch.full_like(cell[:, 0], -1))
    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    first = sorted_cid != torch.roll(sorted_cid, 1)
    first[0] = True
    keep = torch.zeros_like(valid)
    keep[order] = first & (sorted_cid >= 0)
    return keep


def build_grids(points: torch.Tensor, valid: torch.Tensor,
                centers: torch.Tensor, *, cells: int, resolution: float,
                kernel_radius: float) -> torch.Tensor:
    """Distance grids ``[B, cells, cells]`` from reference points
    ``[B, P, 2]`` (mask ``[B, P]``) around ``centers [B, 2]``.

    Points are rasterized into an occupancy mask padded by one patch (so
    points just outside still shade interior cells); then squared column
    distances (±r rows) and squared row distances (±r columns) are
    min-reduced with shifted copies, the separable form of a capped
    distance transform.
    """
    bsz = points.shape[0]
    dev = points.device
    _, r_cells = _kernel_patch(kernel_radius, resolution)
    pad = r_cells + 1
    big = float((kernel_radius * 4.0) ** 2)

    cell = world_to_cell(points, centers[:, None, :], cells, resolution)
    inside = ((cell[..., 0] >= -pad) & (cell[..., 0] < cells + pad)
              & (cell[..., 1] >= -pad) & (cell[..., 1] < cells + pad))
    use = valid & inside
    c = cells + 2 * pad
    flat = (torch.arange(bsz, device=dev)[:, None] * (c * c)
            + (cell[..., 1].long() + pad) * c + (cell[..., 0].long() + pad))
    # unused points go to one trash slot past the end: only real hits are
    # written (a parked point must not mark a real cell)
    flat = torch.where(use, flat, torch.full_like(flat, bsz * c * c))
    occ = torch.zeros(bsz * c * c + 1, dtype=torch.bool, device=dev)
    occ[flat.reshape(-1)] = torch.ones((), dtype=torch.bool, device=dev)
    occ = occ[:-1].reshape(bsz, c, c)

    col = torch.where(occ, torch.zeros((), device=dev),
                      torch.full((), big, device=dev))
    dcol = col
    for dy in range(1, r_cells + 1):
        w = float((dy * resolution) ** 2)
        up = torch.full_like(col, big)
        up[:, :-dy] = col[:, dy:] + w
        dn = torch.full_like(col, big)
        dn[:, dy:] = col[:, :-dy] + w
        dcol = torch.minimum(dcol, torch.minimum(up, dn))

    d2 = dcol
    for dx in range(1, r_cells + 1):
        w = float((dx * resolution) ** 2)
        lf = torch.full_like(dcol, big)
        lf[:, :, :-dx] = dcol[:, :, dx:] + w
        rt = torch.full_like(dcol, big)
        rt[:, :, dx:] = dcol[:, :, :-dx] + w
        d2 = torch.minimum(d2, torch.minimum(lf, rt))

    g = torch.clamp(torch.sqrt(d2), max=kernel_radius)
    return g[:, pad:pad + cells, pad:pad + cells].contiguous()


def build_grid(points: torch.Tensor, valid: torch.Tensor,
               center: torch.Tensor, *, cells: int, resolution: float,
               kernel_radius: float) -> torch.Tensor:
    """One distance grid ``[cells, cells]`` from points ``[P, 2]``."""
    return build_grids(points[None], valid[None], center[None], cells=cells,
                       resolution=resolution,
                       kernel_radius=kernel_radius)[0]
