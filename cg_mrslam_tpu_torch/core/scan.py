"""Fixed-shape laser scan storage + geometry.

Port of ``cg_mrslam_tpu/core/scan.py``: scans live in one ``[N, B]`` ranges
tensor aligned with the pose-graph vertex slots.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cg_mrslam_tpu_torch.utils import se2


@dataclasses.dataclass(frozen=True)
class ScanSet:
    """Scans for every vertex slot of a graph (masked like the graph).

    ``ranges`` is ``[N, B]``; invalid/out-of-range beams are stored as
    ``max_range`` (masked by :func:`beam_valid`). The angular layout
    (``first_beam_angle`` + k·``angular_step``) and the base→laser offset
    are shared per robot.
    """

    ranges: torch.Tensor            # [N, B] float32
    smask: torch.Tensor             # [N] bool — vertex slot has a scan
    first_beam_angle: torch.Tensor  # [] float32
    angular_step: torch.Tensor      # [] float32
    max_range: torch.Tensor         # [] float32
    usable_range: torch.Tensor      # [] float32 — beams beyond are cropped
    laser_offset: torch.Tensor      # [3] — base→laser SE(2) transform


def empty(num_vertices: int, beams: int, device,
          first_beam_angle=-math.pi / 2, angular_step=None, max_range=20.0,
          usable_range=None, fov=math.pi) -> ScanSet:
    if angular_step is None:
        angular_step = fov / beams
    if usable_range is None:
        usable_range = max_range

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return ScanSet(
        ranges=torch.full((num_vertices, beams), float(max_range),
                          dtype=torch.float32, device=device),
        smask=torch.zeros((num_vertices,), dtype=torch.bool, device=device),
        first_beam_angle=scalar(first_beam_angle),
        angular_step=scalar(angular_step),
        max_range=scalar(max_range),
        usable_range=scalar(usable_range),
        laser_offset=torch.zeros((3,), dtype=torch.float32, device=device),
    )


def set_scan(s: ScanSet, index, ranges: torch.Tensor) -> ScanSet:
    idx = torch.as_tensor(index, device=s.ranges.device).long().reshape(-1)
    r = s.ranges.clone()
    r[idx] = ranges.to(r.dtype)
    m = s.smask.clone()
    m[idx] = torch.ones((), dtype=torch.bool, device=m.device)
    return dataclasses.replace(s, ranges=r, smask=m)


def resample_scan_np(ranges, src_fba: float, src_step: float,
                     src_maxr: float, dst_beams: int, dst_fba: float,
                     dst_step: float, dst_maxr: float) -> np.ndarray:
    """Angle-exact host-side resample of one scan ``[B_src]`` (or a stack
    ``[T, B_src]``) onto another beam grid (numpy; a copy of the
    reference's, which log ingestion uses):

    * interpolation is over the real beam angles of both grids;
    * invalid returns (``<= 0`` or ``>= max_range``) do not blend into
      their neighbours: a destination beam whose bracketing source beams
      include an invalid one reads ``dst_maxr``;
    * destination beams outside the source fov read ``dst_maxr``.
    """
    ranges = np.asarray(ranges, np.float32)
    squeeze = ranges.ndim == 1
    rows = ranges[None] if squeeze else ranges
    b_src = rows.shape[-1]
    src_a = src_fba + src_step * np.arange(b_src)
    dst_a = dst_fba + dst_step * np.arange(dst_beams)
    out = np.empty((rows.shape[0], dst_beams), np.float32)
    for t in range(rows.shape[0]):
        r = rows[t]
        invalid = (r <= 0.0) | (r >= src_maxr * 0.9999)
        vals = np.interp(dst_a, src_a, np.minimum(r, src_maxr))
        inv = np.interp(dst_a, src_a, invalid.astype(np.float64))
        oob = (dst_a < src_a[0] - 1e-9) | (dst_a > src_a[-1] + 1e-9)
        vals = np.where((inv > 1e-9) | oob, dst_maxr, vals)
        out[t] = np.minimum(vals, dst_maxr)
    return out[0] if squeeze else out


def beam_angles(s: ScanSet) -> torch.Tensor:
    b = s.ranges.shape[-1]
    return s.first_beam_angle + s.angular_step * torch.arange(
        b, dtype=torch.float32, device=s.ranges.device)


def beam_valid(s: ScanSet, indices=None) -> torch.Tensor:
    r = s.ranges if indices is None else s.ranges[indices]
    return (r > 0.0) & (r < torch.minimum(s.max_range, s.usable_range)
                        * 0.9999)


def points_from_ranges(s: ScanSet, ranges: torch.Tensor):
    """One raw scan ``[B]`` → (points ``[B,2]`` in base frame, valid ``[B]``)
    using the ScanSet's shared laser geometry."""
    a = beam_angles(s)
    pts = torch.stack([ranges * torch.cos(a), ranges * torch.sin(a)], dim=-1)
    valid = (ranges > 0.0) & (
        ranges < torch.minimum(s.max_range, s.usable_range) * 0.9999)
    return se2.apply(s.laser_offset, pts), valid


def scan_points(s: ScanSet, indices=None) -> torch.Tensor:
    """Cartesian endpoints ``[..., B, 2]`` in the robot base frame (invalid
    beams still produce points — mask with :func:`beam_valid`)."""
    r = s.ranges if indices is None else s.ranges[indices]
    a = beam_angles(s)
    pts = torch.stack([r * torch.cos(a), r * torch.sin(a)], dim=-1)
    return se2.apply(s.laser_offset, pts)
