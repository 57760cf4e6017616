"""Trajectory + laser-map visualization export.

Port of ``cg_mrslam_tpu/maps/viz.py`` (the reference's
``GraphRosPublisher``, ``graph_ros_publisher.cpp``): instead of RViz topics
it produces numpy arrays and an image file —

* :func:`trajectory` — all vertex estimates (the ``trajectory`` PoseArray,
  ``graph_ros_publisher.cpp:58-66``);
* :func:`laser_map_points` — every ``stride``-th laser point transformed
  to the map frame (the ``lasermap`` PointCloud, ``:68-91``; reference
  stride is 10);
* :func:`map_to_odom` — the map→odom correction transform the reference
  broadcasts on tf at 10 Hz (``:95-116``): estimate ∘ odom⁻¹;
* :func:`render_png` — a P5 PGM raster of trajectory + laser map (the
  visual the reference screenshots in its README).

The state's functions run on the state's device and fetch the result to
the host once. World points come from ``se2.apply``, whose rotation is
rounded from float64 (``se2.cos_sin``): the card and the CPU give the same
points.
"""

from __future__ import annotations

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.pipeline.slam import SlamState
from cg_mrslam_tpu_torch.utils import se2


def trajectory(state: SlamState, own_only: bool = True) -> np.ndarray:
    """Vertex estimates ``[K, 3]`` in slot order."""
    mask = state.graph.vmask
    if own_only:
        mask = mask & (state.v_owner == state.my_id)
    return state.graph.poses[mask].cpu().numpy()


def laser_map_points(state: SlamState, stride: int = 10) -> np.ndarray:
    """World-frame laser endpoints ``[M, 2]``, every ``stride``-th beam."""
    pts = S.scan_points(state.scans)                   # [N,B,2]
    world = se2.apply(state.graph.poses, pts)
    valid = (S.beam_valid(state.scans) & state.scans.smask[:, None]
             & state.graph.vmask[:, None])
    return world[valid].cpu().numpy()[::stride]


def map_to_odom(estimate: np.ndarray, odom: np.ndarray,
                device=None) -> np.ndarray:
    """The tf correction map→odom = estimate ∘ odom⁻¹ (float32, on
    ``device``: the card unless the caller names another)."""
    dev = resolve_device(device)
    est = torch.as_tensor(np.asarray(estimate, np.float32), device=dev)
    odo = torch.as_tensor(np.asarray(odom, np.float32), device=dev)
    return se2.compose(est, se2.inverse(odo)).cpu().numpy()


def render_png(path: str, state: SlamState, resolution: float = 0.05,
               pad: float = 2.0) -> None:
    """Rasterize laser map (grey) + trajectory (black) to a PGM image."""
    traj = trajectory(state, own_only=False)
    pts = laser_map_points(state, stride=1)
    if len(traj) == 0:
        return
    allp = np.concatenate([traj[:, :2], pts]) if len(pts) else traj[:, :2]
    lo = allp.min(0) - pad
    hi = allp.max(0) + pad
    w = int(np.ceil((hi[0] - lo[0]) / resolution))
    h = int(np.ceil((hi[1] - lo[1]) / resolution))
    img = np.full((h, w), 255, np.uint8)

    def cells(p):
        c = np.floor((p - lo) / resolution).astype(int)
        ok = (c[:, 0] >= 0) & (c[:, 0] < w) & (c[:, 1] >= 0) & (c[:, 1] < h)
        return c[ok]

    for c in cells(pts):
        img[c[1], c[0]] = 160
    for c in cells(traj[:, :2]):
        img[max(c[1] - 1, 0):c[1] + 2, max(c[0] - 1, 0):c[0] + 2] = 0

    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img[::-1].tobytes())
