"""Sensor ingestion abstraction — the RosHandler equivalent.

Port of ``cg_mrslam_tpu/io/stream.py``. The reference's ``RosHandler``
(``ros_handler.cpp:112-180``) blocks on the first odometry + scan,
captures the laser geometry, then feeds the main loop one (odometry,
scan) pair per spin. Here the same contract is a :class:`SensorSource`:
``open()`` blocks until the first measurement pair and returns the sensor
geometry; ``read()`` yields ``(rel_odom, ranges)`` increments until the
stream ends.

Three sources cover the reference's three data paths:

* :class:`ReplaySource` — offline logs (CARMEN .clf; the bag-replay role);
* :class:`SimSource` — the synthetic world (its scans ray-cast on
  ``device``, the card unless the caller names another);
* :class:`UdpJsonSource` — LIVE ingestion over a datagram socket: one JSON
  object per datagram, ``{"odom": [x, y, th], "ranges": [...]}`` (+ a
  one-time ``{"geometry": {...}}`` header), the counterpart of subscribing
  to odom/scan topics. Any driver or bridge process can feed it.

The sources are plain-Python iterators on the host (ingestion is I/O);
:func:`run_slam_on_source` drives ``SingleRobotSlam`` on the card.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SensorGeometry:
    """What RosHandler captures at init: beam layout + laser mount."""

    beams: int
    first_beam_angle: float
    angular_step: float
    max_range: float
    laser_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def fov(self) -> float:
        return self.angular_step * self.beams


class SensorSource:
    """Contract: ``open()`` blocks until the sensor is live and returns
    (geometry, initial_pose, first_ranges); ``read()`` iterates
    ``(rel_odom [3], ranges [B])`` pairs."""

    def open(self) -> Tuple[SensorGeometry, np.ndarray, np.ndarray]:
        raise NotImplementedError

    def read(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ReplaySource(SensorSource):
    """CARMEN .clf replay (the reference's rosbag role)."""

    def __init__(self, path: str, beams: int | None = None,
                 max_range: float | None = None):
        from cg_mrslam_tpu_torch.io import carmen

        self._log = carmen.read(path, beams=beams, max_range=max_range)

    def open(self):
        log = self._log
        geom = SensorGeometry(
            beams=log.ranges.shape[1],
            first_beam_angle=log.start_angle,
            angular_step=log.angular_step,
            max_range=log.max_range,
            laser_offset=tuple(log.laser_offset()))
        return geom, log.odom[0], log.ranges[0]

    def read(self):
        rel = self._log.rel_odom()
        for t in range(1, len(self._log.odom)):
            yield rel[t - 1], self._log.ranges[t]


class SimSource(SensorSource):
    """Synthetic hospital world as a sensor stream; the scans are
    ray-cast on ``device`` (the card unless the caller names another)."""

    def __init__(self, width: float = 40.0, height: float = 20.0,
                 robot: int = 0, loops: int = 2, seed: int = 0,
                 beams: int = 360, max_range: float = 10.0,
                 fov: float = 2 * np.pi * 0.75,
                 odom_noise=(0.01, 0.004), device=None):
        from cg_mrslam_tpu_torch.sim import world as W

        world = W.hospital_world(width, height, seed=seed)
        self._traj = W.simulate_robot(
            world, W.corridor_waypoints(width, height, robot, loops),
            seed=seed + 7 * robot + 1, beams=beams, fov=fov,
            max_range=max_range, odom_noise=tuple(odom_noise),
            device=device)
        self._geom = SensorGeometry(
            beams=beams, first_beam_angle=-fov / 2,
            angular_step=fov / beams, max_range=max_range)

    def open(self):
        return self._geom, self._traj.gt[0], self._traj.ranges[0]

    def read(self):
        for t in range(1, len(self._traj.gt)):
            yield self._traj.rel_odom[t - 1], self._traj.ranges[t]


class UdpJsonSource(SensorSource):
    """Live sensor ingestion: one JSON datagram per measurement.

    Protocol (any driver process can speak it):
      1. optionally ``{"geometry": {"beams": B, "first_beam_angle": a,
         "angular_step": s, "max_range": m, "laser_offset": [x,y,th]}}``
      2. then ``{"odom": [x, y, th], "ranges": [r0, ..., r_{B-1}]}``
         with ABSOLUTE odometry — relative increments are derived here in
         float64, exactly like the reference dead-reckons between ROS
         odometry callbacks (``cg_mrslam.cpp:210-212``).

    ``open()`` blocks until the first measurement (the reference's
    ``waitForMessage`` behaviour, ``ros_handler.cpp:112-143``) and raises
    ``TimeoutError`` when none arrives within ``timeout`` seconds.
    """

    def __init__(self, port: int, host: str = "0.0.0.0",
                 timeout: Optional[float] = None,
                 default_geometry: Optional[SensorGeometry] = None):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout)
        self._geom = default_geometry
        self._last_odom: Optional[np.ndarray] = None

    def _next_packet(self) -> Optional[dict]:
        try:
            buf, _ = self._sock.recvfrom(1 << 20)
        except socket.timeout:
            return None
        return json.loads(buf.decode())

    def open(self):
        while True:
            pkt = self._next_packet()
            if pkt is None:
                raise TimeoutError("no sensor data before timeout")
            if "geometry" in pkt:
                g = pkt["geometry"]
                self._geom = SensorGeometry(
                    beams=int(g["beams"]),
                    first_beam_angle=float(g["first_beam_angle"]),
                    angular_step=float(g["angular_step"]),
                    max_range=float(g["max_range"]),
                    laser_offset=tuple(g.get("laser_offset",
                                             (0.0, 0.0, 0.0))))
                continue
            if "odom" in pkt and "ranges" in pkt:
                odom = np.asarray(pkt["odom"], np.float64)
                ranges = np.asarray(pkt["ranges"], np.float32)
                if self._geom is None:
                    # geometry never sent: assume a symmetric π field of
                    # view
                    b = ranges.shape[0]
                    self._geom = SensorGeometry(
                        beams=b, first_beam_angle=-np.pi / 2,
                        angular_step=np.pi / b,
                        max_range=float(ranges.max()))
                self._last_odom = odom
                return self._geom, odom, ranges

    def read(self):
        while True:
            pkt = self._next_packet()
            if pkt is None:
                return
            if "odom" not in pkt:
                continue
            odom = np.asarray(pkt["odom"], np.float64)
            ranges = np.asarray(pkt["ranges"], np.float32)
            a = self._last_odom
            c, s = np.cos(a[2]), np.sin(a[2])
            dx, dy = odom[0] - a[0], odom[1] - a[1]
            rel = np.array([
                c * dx + s * dy, -s * dx + c * dy,
                (odom[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])
            self._last_odom = odom
            yield rel, ranges

    def close(self):
        self._sock.close()


def run_slam_on_source(source: SensorSource, cfg=None,
                       max_keyframes: int | None = None, device=None):
    """Drive a ``SingleRobotSlam`` from any SensorSource (the srslam main
    loop against the ingestion seam), on ``device`` (the card unless the
    caller names another). Returns the SLAM driver."""
    from cg_mrslam_tpu_torch.config import DEFAULT
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

    cfg = cfg or DEFAULT
    geom, pose0, ranges0 = source.open()
    slam = SingleRobotSlam(
        cfg, geom.beams, pose0, ranges0, geom.fov, geom.max_range,
        laser_offset=geom.laser_offset,
        first_beam_angle=geom.first_beam_angle,
        angular_step=geom.angular_step, device=device)
    for rel, ranges in source.read():
        slam.observe(rel, ranges)
        if max_keyframes and len(slam.infos) >= max_keyframes:
            break
    return slam
