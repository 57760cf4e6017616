"""Occupancy-grid mapping: ray-cast integration of every stored scan.

Port of ``cg_mrslam_tpu/maps/occupancy.py`` (the reference's map publisher
stack: ``Graph2occupancy::computeMap``, ``FrequencyMap::integrateScan``,
``OccupancyMapServer``). Every (scan × beam × sample) triple is generated
as a lattice: free-space samples add one miss to their cell, endpoints add
``gain`` hits. Samples are spaced ``resolution/√2`` along each ray and a
cell visited by consecutive samples counts once, which matches Bresenham's
counts closely enough for the thresholds.

The scans are integrated in chunks (:data:`CHUNK_SAMPLES` samples at a
time), so peak memory stays bounded at any map size. The counts are small
integers added in float32, which is exact in any order, so neither the
chunking nor the order of the scatter-adds changes a count.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cg_mrslam_tpu_torch.core.scan import ScanSet, beam_angles
from cg_mrslam_tpu_torch.utils import se2

FREE = 0
UNKNOWN = -1
OCCUPIED = 100

# samples integrated at a time: ~0.5 GB of temporaries at the peak
CHUNK_SAMPLES = 1 << 23


class OccupancyGrid(NamedTuple):
    hits: torch.Tensor    # [C, C] float32
    misses: torch.Tensor  # [C, C] float32
    center: torch.Tensor  # [2] world center of the grid
    resolution: float


def _cell_of(p, center, cells, resolution):
    rel = (p - center) / resolution + cells / 2.0
    return torch.floor(rel).to(torch.int32)


def _add(grid: torch.Tensor, cell: torch.Tensor, ok: torch.Tensor,
         value: float, cells: int) -> None:
    """Add ``value`` at every ``cell [..., 2]`` (x, y) where ``ok``; the
    rest lands on the grid's spare last element."""
    flat = torch.where(ok, cell[..., 1].long() * cells + cell[..., 0].long(),
                       torch.full_like(ok, cells * cells, dtype=torch.long))
    flat = flat.reshape(-1)
    grid.index_add_(0, flat, torch.full(flat.shape, value,
                                        dtype=grid.dtype, device=grid.device))


def _square(half: int, device) -> torch.Tensor:
    """``[(2h+1)², 2]`` offsets of a square of half-width ``half``."""
    r = torch.arange(-half, half + 1, device=device)
    return torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)


def integrate(poses: torch.Tensor, scans: ScanSet, center: torch.Tensor, *,
              cells: int, resolution: float, max_range: float,
              usable_range: float = -1.0, gain: float = 3.0,
              square_size: int = 0, infinity_filling_range: float = -1.0,
              angle: float = 0.0, robot_fill: int = 4) -> OccupancyGrid:
    """Hit and miss grids from every stored scan at its (optimized) pose.

    ``poses [N,3]`` are the graph's estimates; the scans come from the
    ScanSet aligned with the vertex slots. Beams are classified in the
    reference's branch order (``frequency_map.cpp:31-50``):

    1. ``usable_range < 0`` → use the sensor's max range;
    2. ``r > usable`` → crop to usable, trace free space, score no hit;
    3. then ``r >= max_range or r <= 0`` (a beam cropped to ``usable ==
       max_range`` also lands here): with ``infinity_filling_range > 0``
       the beam traces free space to that range and scores no hit;
       otherwise it is skipped.

    Endpoints add ``gain`` hits over a ``(2·square_size+1)²`` square; the
    Bresenham line includes its endpoint, so every reaching beam also adds
    one miss there. ``angle`` rotates every pose first (the map's base
    transform). ``robot_fill`` adds misses over a ``(2·robot_fill+1)²``
    square at each robot pose (``fillRobotPose``); < 0 disables it.
    """
    dev = poses.device
    usable = usable_range if usable_range > 0 else max_range
    if angle != 0.0:
        base = torch.tensor([0.0, 0.0, angle], dtype=poses.dtype,
                            device=dev)
        poses = se2.compose(base, poses)
    trace_cap = usable if infinity_filling_range <= 0 else max(
        usable, infinity_filling_range)
    step = resolution / math.sqrt(2.0)
    n_samples = int(math.ceil(trace_cap / step)) + 1
    center = center.to(device=dev, dtype=torch.float32)

    a = beam_angles(scans)                                   # [B]
    world_ang = poses[:, 2:3] + a[None, :]                   # [N,B]
    origin = se2.apply(poses, scans.laser_offset[None, :2])[:, 0, :]

    r_raw = scans.ranges
    cropped = r_raw > usable                                 # [N,B]
    r = torch.clamp(r_raw, max=usable)
    invalid = (r >= max_range) | (r <= 0.0)                  # post-crop test
    if infinity_filling_range > 0:
        r = torch.where(invalid, torch.full_like(r, infinity_filling_range),
                        r)
        cropped = cropped | invalid
        beam_ok = scans.smask[:, None].expand_as(r)
    else:
        beam_ok = scans.smask[:, None] & ~invalid
    is_hit = beam_ok & ~cropped
    dirx, diry = torch.cos(world_ang), torch.sin(world_ang)

    size = cells * cells + 1                                 # + spare
    misses = torch.zeros((size,), dtype=torch.float32, device=dev)
    hits = torch.zeros((size,), dtype=torch.float32, device=dev)
    t = (torch.arange(n_samples, dtype=torch.float32, device=dev)
         + 0.5) * step                                       # [S]
    n, beams = r.shape
    chunk = max(1, CHUNK_SAMPLES // (beams * n_samples))
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))
        o, rr, ok = origin[sl], r[sl], beam_ok[sl]
        free = t < (rr[..., None] - resolution)              # [n,B,S]
        sx = o[:, None, None, 0] + dirx[sl, :, None] * t
        sy = o[:, None, None, 1] + diry[sl, :, None] * t
        cell = _cell_of(torch.stack([sx, sy], -1), center, cells,
                        resolution)
        # a cell visited by consecutive samples of a ray counts once
        same = torch.all(cell == torch.roll(cell, 1, dims=-2), dim=-1)
        same[..., 0] = False
        inb = torch.all((cell >= 0) & (cell < cells), dim=-1)
        _add(misses, cell, free & ok[..., None] & ~same & inb, 1.0, cells)

    ex = origin[:, 0:1] + dirx * r
    ey = origin[:, 1:2] + diry * r
    ecell = _cell_of(torch.stack([ex, ey], -1), center, cells, resolution)
    einb = torch.all((ecell >= 0) & (ecell < cells), dim=-1)
    # the Bresenham line includes its endpoint: one miss there per beam
    _add(misses, ecell, beam_ok & einb, 1.0, cells)

    if robot_fill >= 0:
        rsq = (_cell_of(poses[:, :2], center, cells, resolution)[:, None]
               + _square(robot_fill, dev)[None])             # [N,F,2]
        rinb = torch.all((rsq >= 0) & (rsq < cells), dim=-1) \
            & scans.smask[:, None]
        _add(misses, rsq, rinb, 1.0, cells)

    # endpoint hits over the (2s+1)² square; each cell is bounds-checked on
    # its own, and only the centre's test gates the splat
    esq = ecell[:, :, None, :] + _square(square_size, dev)[None, None]
    sinb = torch.all((esq >= 0) & (esq < cells), dim=-1)
    _add(hits, esq, (is_hit & einb)[..., None] & sinb, gain, cells)

    return OccupancyGrid(hits=hits[:-1].reshape(cells, cells),
                         misses=misses[:-1].reshape(cells, cells),
                         center=center, resolution=resolution)


def threshold(grid: OccupancyGrid, occupied_threshold: float = 0.65,
              free_threshold: float = 0.196) -> torch.Tensor:
    """Trinary map ``[C, C]`` int8: FREE (0) / UNKNOWN (-1) / OCCUPIED (100)
    (``graph2occupancy.cpp:133-151`` and the nav_msgs convention)."""
    total = grid.hits + grid.misses
    ratio = grid.hits / torch.clamp(total, min=1e-9)
    out = torch.full(ratio.shape, UNKNOWN, dtype=torch.int8,
                     device=ratio.device)
    out = torch.where((total > 0) & (ratio < free_threshold),
                      torch.full_like(out, FREE), out)
    return torch.where((total > 0) & (ratio > occupied_threshold),
                       torch.full_like(out, OCCUPIED), out)


def map_center(poses: np.ndarray, pad: float = 1.0) -> np.ndarray:
    """World center of a grid covering all poses (host helper)."""
    lo = poses[:, :2].min(axis=0) - pad
    hi = poses[:, :2].max(axis=0) + pad
    return ((lo + hi) / 2.0).astype(np.float32)


def save_pgm_yaml(path_base: str, tri: np.ndarray, center: np.ndarray,
                  resolution: float) -> None:
    """A ROS map-server .pgm + .yaml pair (the reference writes .png +
    .yaml, ``occupancy_map_server.cpp:128-169``). Row 0 is the map's top
    (y max), as map servers expect."""
    c = tri.shape[0]
    img = np.full(tri.shape, 205, np.uint8)      # unknown -> grey
    img[tri == FREE] = 254
    img[tri == OCCUPIED] = 0
    img = img[::-1]                               # rows in image order
    with open(path_base + ".pgm", "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (c, c))
        f.write(img.tobytes())
    ox = float(center[0]) - resolution * c / 2.0
    oy = float(center[1]) - resolution * c / 2.0
    with open(path_base + ".yaml", "w") as f:
        f.write(
            "image: %s.pgm\nresolution: %f\norigin: [%f, %f, 0.0]\n"
            "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n"
            % (path_base.rsplit("/", 1)[-1], resolution, ox, oy))
