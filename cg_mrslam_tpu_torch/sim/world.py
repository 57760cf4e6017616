"""Synthetic hospital-like 2D world + lidar + trajectory simulation.

Port of ``cg_mrslam_tpu/sim/world.py``: a deterministic, seeded corridor and
room floorplan of wall segments, an exact ray-cast lidar (one ``[beams ×
segments]`` intersection reduce per pose, in torch), and unicycle
trajectories with odometry noise drawn from numpy's ``default_rng`` — the
scan source of the single-robot path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device


# poses ray-cast per call: bounds the [poses, beams, segments] temporaries
_RAYCAST_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class World:
    """Axis-aligned wall segments ``[S, 4]`` = (x1, y1, x2, y2)."""

    segments: np.ndarray

    def as_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(self.segments, dtype=torch.float32,
                               device=device)


def hospital_world(width: float = 40.0, height: float = 20.0,
                   corridor: float = 3.0, room: float = 5.0,
                   door: float = 1.2, seed: int = 0) -> World:
    """A hospital-like floorplan: central E-W corridor with rooms on both
    sides connected by doors, obstacles in the rooms and clutter along the
    corridor walls (a bare rectangular corridor is π-symmetric, which no
    correlative matcher can disambiguate). Deterministic for a seed."""
    rng = np.random.default_rng(seed)
    segs: List[Tuple[float, float, float, float]] = []
    segs += [
        (0, 0, width, 0), (width, 0, width, height),
        (width, height, 0, height), (0, height, 0, 0),
    ]
    cy0 = height / 2 - corridor / 2
    cy1 = height / 2 + corridor / 2
    x = 0.0
    while x + room <= width + 1e-6:
        nx = x + room
        for (y, sgn) in ((cy0, -1), (cy1, +1)):
            dpos = x + rng.uniform(0.8, room - 0.8 - door)
            segs.append((x, y, dpos, y))
            segs.append((dpos + door, y, nx, y))
            if nx < width - 1e-6:
                y_far = 0.0 if sgn < 0 else height
                segs.append((nx, y, nx, y_far))
        x = nx
    for _ in range(10):
        ox = rng.uniform(1, width - 2)
        oy = rng.uniform(1, cy0 - 1) if rng.uniform() < 0.5 else rng.uniform(
            cy1 + 1, height - 2)
        w, h = rng.uniform(0.4, 1.5, 2)
        segs += [
            (ox, oy, ox + w, oy), (ox + w, oy, ox + w, oy + h),
            (ox + w, oy + h, ox, oy + h), (ox, oy + h, ox, oy),
        ]
    for _ in range(max(4, int(width / 8))):
        ox = rng.uniform(1.0, width - 2.0)
        side = rng.uniform() < 0.5
        oy = cy0 + 0.05 if side else cy1 - 0.45
        w = rng.uniform(0.3, 0.9)
        h = 0.4
        segs += [
            (ox, oy, ox + w, oy), (ox + w, oy, ox + w, oy + h),
            (ox + w, oy + h, ox, oy + h), (ox, oy + h, ox, oy),
        ]
    return World(segments=np.asarray(segs, np.float32))


def raycast(segments: torch.Tensor, poses: torch.Tensor, beams: int,
            first_beam_angle: float, angular_step: float,
            max_range: float) -> torch.Tensor:
    """Exact lidar: ranges ``[..., beams]`` from poses ``[..., 3]`` against
    ``[S,4]`` walls (closed-form ray/segment intersection, min over
    segments)."""
    a = poses[..., 2, None] + first_beam_angle + angular_step * torch.arange(
        beams, dtype=torch.float32, device=poses.device)       # [...,B]
    dx, dy = torch.cos(a)[..., None], torch.sin(a)[..., None]  # [...,B,1]
    ox = poses[..., 0, None, None]
    oy = poses[..., 1, None, None]
    vx = segments[:, 2] - segments[:, 0]                       # [S]
    vy = segments[:, 3] - segments[:, 1]
    pox = segments[:, 0] - ox                                  # [...,1,S]
    poy = segments[:, 1] - oy
    denom = dx * vy - dy * vx                                  # [...,B,S]
    t_num = pox * vy - poy * vx
    u_num = pox * dy - poy * dx
    degenerate = torch.abs(denom) < 1e-9
    safe = torch.where(degenerate, torch.ones_like(denom), denom)
    t = t_num / safe
    u = u_num / safe
    hit = ~degenerate & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    r = torch.min(t, dim=-1).values
    return torch.clamp(r, max=max_range)


def corridor_waypoints(world_w: float, world_h: float, robot: int,
                       n_loops: int = 1) -> np.ndarray:
    """A rectangular patrol route in the corridor, phase-shifted per robot
    (reverse direction for odd robots) so robots meet and separate."""
    cy = world_h / 2
    m = 4.0
    pts = np.array(
        [[m, cy - 0.5], [world_w - m, cy - 0.5],
         [world_w - m, cy + 0.5], [m, cy + 0.5]])
    if robot % 2 == 1:
        pts = pts[::-1]
    pts = np.roll(pts, shift=robot, axis=0)
    return np.tile(pts, (n_loops + 1, 1))[: 4 * n_loops + 1]


@dataclasses.dataclass
class Trajectory:
    """Ground truth + noisy odometry + scans for one robot."""

    gt: np.ndarray          # [T, 3]
    odom: np.ndarray        # [T, 3] integrated noisy odometry
    rel_odom: np.ndarray    # [T-1, 3] noisy relative motions
    ranges: np.ndarray      # [T, B]


def simulate_robot(world: World, waypoints: np.ndarray, seed: int,
                   step: float = 0.08, beams: int = 180,
                   fov: float = 2 * np.pi * 0.75, max_range: float = 10.0,
                   odom_noise: Tuple[float, float] = (0.01, 0.004),
                   device=None) -> Trajectory:
    """Drive through waypoints with a unicycle model; emit gt poses, noisy
    odometry (numpy, seeded) and exact lidar scans (ray-cast on ``device``,
    the card by default, ``_RAYCAST_CHUNK`` poses at a time)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pos = waypoints[0].astype(np.float64)
    heading = float(np.arctan2(*(waypoints[1] - waypoints[0])[::-1]))
    gt = [np.array([pos[0], pos[1], heading])]
    k = 1
    max_steps = 20000
    while k < len(waypoints) and len(gt) < max_steps:
        tgt = waypoints[k]
        d = tgt - pos
        dist = np.hypot(*d)
        if dist < step:
            pos = tgt.astype(np.float64)
            k += 1
            continue
        want = np.arctan2(d[1], d[0])
        dth = (want - heading + np.pi) % (2 * np.pi) - np.pi
        dth = np.clip(dth, -0.15, 0.15)
        heading = (heading + dth + np.pi) % (2 * np.pi) - np.pi
        pos = pos + step * np.array([np.cos(heading), np.sin(heading)])
        gt.append(np.array([pos[0], pos[1], heading]))
    gt = np.asarray(gt)

    def np_rel(a, b):
        c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
        dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
        th = (b[..., 2] - a[..., 2] + np.pi) % (2 * np.pi) - np.pi
        return np.stack([c * dx + s * dy, -s * dx + c * dy, th], axis=-1)

    rel = np_rel(gt[:-1], gt[1:])
    sig_t, sig_r = odom_noise
    noise = np.concatenate(
        [rng.normal(0, sig_t, (len(rel), 2)),
         rng.normal(0, sig_r, (len(rel), 1))], axis=1)
    rel_noisy = rel + noise
    odom = np.zeros_like(gt)
    odom[0] = gt[0]
    for k2, r in enumerate(rel_noisy):
        a = odom[k2]
        c, s = np.cos(a[2]), np.sin(a[2])
        odom[k2 + 1] = [
            a[0] + c * r[0] - s * r[1],
            a[1] + s * r[0] + c * r[1],
            (a[2] + r[2] + np.pi) % (2 * np.pi) - np.pi,
        ]

    segs = world.as_tensor(dev)
    poses = torch.as_tensor(gt.astype(np.float32), device=dev)
    ranges = torch.cat([
        raycast(segs, poses[i:i + _RAYCAST_CHUNK], beams, -fov / 2,
                fov / beams, max_range)
        for i in range(0, len(gt), _RAYCAST_CHUNK)])
    return Trajectory(gt=gt, odom=odom, rel_odom=np.asarray(rel_noisy),
                      ranges=ranges.cpu().numpy())
