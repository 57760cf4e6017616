"""CARMEN log (.clf) ingestion: the real-data path (host-side numpy).

Port of ``cg_mrslam_tpu/io/carmen.py`` (a copy; the port keeps its own). The
reference feeds sensors from ROS bagfiles; CARMEN logs are the public
interchange format for 2D laser + odometry logs (Freiburg, Intel, MIT
datasets). :func:`read` parses a .clf, puts every scan on one fixed beam grid
(``core.scan.resample_scan_np``: explicit geometry per record, invalid
returns never blend into their neighbours) and exposes the relative odometry
the keyframe loop consumes. Two record families:

* ``FLASER num [ranges...] lx ly lth ox oy oth ts host lts`` — classic SICK
  logs: a π fov with endpoint-inclusive spacing ``π/(num−1)`` from −π/2;
* ``ROBOTLASER1 type start fov ares maxr acc rem num [ranges...] <0 rem>
  lx ly lth ox oy oth tv rv fwd side turn ts host lts`` — explicit beam
  geometry; what :func:`write` emits, so round trips are lossless.

The log's ``start_angle`` and ``angular_step`` describe the returned ranges
array; feed them to the pipeline (``SingleRobotSlam(first_beam_angle=...,
angular_step=...)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cg_mrslam_tpu_torch.core.scan import resample_scan_np


@dataclasses.dataclass
class CarmenLog:
    """One robot's laser+odometry stream in array form. ``ranges [T, B]``
    lies on the grid ``start_angle + angular_step·k`` (laser frame)."""

    odom: np.ndarray        # [T, 3] robot odometry pose per scan
    laser_pose: np.ndarray  # [T, 3] laser pose per scan (world frame)
    ranges: np.ndarray      # [T, B]
    timestamps: np.ndarray  # [T]
    fov: float              # angular span: angular_step * (B - 1)
    start_angle: float      # of beam 0, relative to robot heading
    angular_step: float     # between consecutive beams
    max_range: float

    def rel_odom(self) -> np.ndarray:
        """[T-1, 3] relative motions x_i^{-1} x_{i+1} (the dead-reckoning
        increments the keyframe loop consumes)."""
        a, b = self.odom[:-1], self.odom[1:]
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
        dth = (b[:, 2] - a[:, 2] + np.pi) % (2 * np.pi) - np.pi
        return np.stack([c * dx + s * dy, -s * dx + c * dy, dth], 1)

    def laser_offset(self) -> np.ndarray:
        """Base→laser SE(2) transform ``odom⁻¹ ∘ laser_pose`` (median
        over records — constant up to odometry noise; e.g. the Intel
        dataset's 0.08 m front-laser offset)."""
        c, s = np.cos(self.odom[:, 2]), np.sin(self.odom[:, 2])
        dx = self.laser_pose[:, 0] - self.odom[:, 0]
        dy = self.laser_pose[:, 1] - self.odom[:, 1]
        dth = (self.laser_pose[:, 2] - self.odom[:, 2] + np.pi) \
            % (2 * np.pi) - np.pi
        rel = np.stack([c * dx + s * dy, -s * dx + c * dy, dth], 1)
        return np.median(rel, axis=0)


def read(path: str, beams: int | None = None,
         max_range: float | None = None) -> CarmenLog:
    """Parse a CARMEN .clf into a :class:`CarmenLog`.

    ``beams`` resamples every scan to a fixed count over the first
    record's angular span (required when the log mixes laser models);
    ``max_range`` overrides/clips the sensor range (invalid returns in
    CARMEN logs are encoded as huge ranges and snap to max range, never
    blending into neighbours).
    """
    odom, lpose, ts = [], [], []
    rows: list = []            # (ranges, start, ares, maxr)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "FLASER":
                n = int(tok[1])
                r = np.array(tok[2:2 + n], np.float32)
                vals = tok[2 + n:2 + n + 7]
                lpose.append([float(v) for v in vals[0:3]])
                odom.append([float(v) for v in vals[3:6]])
                ts.append(float(vals[6]))
                # classic SICK: endpoint-inclusive π fov
                ares = np.pi / max(n - 1, 1)
                rows.append((r, -np.pi / 2, ares, 81.9))
            elif tok[0] == "ROBOTLASER1":
                start = float(tok[2])
                fov = float(tok[3])
                ares = float(tok[4])
                maxr = float(tok[5])
                n = int(tok[8])
                r = np.array(tok[9:9 + n], np.float32)
                k = 9 + n
                nrem = int(tok[k])
                k += 1 + nrem
                vals = tok[k:k + 6]
                lpose.append([float(v) for v in vals[0:3]])
                odom.append([float(v) for v in vals[3:6]])
                ts.append(float(tok[k + 11]) if len(tok) > k + 11 else 0.0)
                if ares <= 0:  # defensive: derive from fov
                    ares = fov / max(n - 1, 1)
                rows.append((r, start, ares, maxr))
    if not rows:
        raise ValueError(f"no FLASER/ROBOTLASER1 records in {path}")

    # target grid: first record's geometry, optionally re-gridded to
    # `beams` over the same angular span
    r0, start0, ares0, maxr0 = rows[0]
    span0 = ares0 * (len(r0) - 1)
    if beams is not None:
        b = beams
        step = span0 / max(b - 1, 1)
    else:
        b = len(r0)
        step = ares0
    out_maxr = float(max_range) if max_range is not None else float(maxr0)

    uniform = all(len(r) == len(r0) and abs(s - start0) < 1e-9
                  and abs(a - ares0) < 1e-12 and abs(m - maxr0) < 1e-6
                  for (r, s, a, m) in rows)
    if uniform and b == len(r0) and abs(step - ares0) < 1e-12 \
            and out_maxr >= maxr0:
        ranges = np.stack([r for (r, *_rest) in rows])
        # normalize invalid returns to the output max range
        invalid = (ranges <= 0.0) | (ranges >= maxr0 * 0.9999)
        ranges = np.where(invalid, out_maxr,
                          np.minimum(ranges, out_maxr)).astype(np.float32)
    else:
        ranges = np.stack([
            resample_scan_np(r, s, a, min(m, out_maxr) if max_range
                             else m, b, start0, step, out_maxr)
            for (r, s, a, m) in rows
        ])

    return CarmenLog(
        odom=np.asarray(odom, np.float64),
        laser_pose=np.asarray(lpose, np.float64),
        ranges=np.minimum(ranges, out_maxr).astype(np.float32),
        timestamps=np.asarray(ts, np.float64),
        fov=float(step * (b - 1)), start_angle=float(start0),
        angular_step=float(step), max_range=float(out_maxr))


def write(path: str, odom: np.ndarray, ranges: np.ndarray, fov: float,
          max_range: float, laser_pose: np.ndarray | None = None,
          timestamps: np.ndarray | None = None,
          start_angle: float | None = None,
          angular_step: float | None = None) -> None:
    """Emit ROBOTLASER1 records (explicit beam geometry → lossless
    round-trip). The declared ``ares`` matches the ACTUAL spacing of the
    data: pass ``angular_step`` when known; otherwise it derives as
    ``fov/(B-1)`` and ``fov`` must be the endpoint-inclusive span of the
    rows being written."""
    T, B = ranges.shape
    if laser_pose is None:
        laser_pose = odom
    if timestamps is None:
        timestamps = 0.1 * np.arange(T)
    ares = angular_step if angular_step is not None else fov / max(B - 1, 1)
    start = start_angle if start_angle is not None else -fov / 2
    span = ares * (B - 1)
    with open(path, "w") as f:
        f.write("# carmen log written by cg_mrslam_tpu_torch\n")
        for t in range(T):
            r = " ".join(f"{v:.3f}" for v in ranges[t])
            lp = " ".join(f"{v:.6f}" for v in laser_pose[t])
            op = " ".join(f"{v:.6f}" for v in odom[t])
            f.write(
                f"ROBOTLASER1 0 {start:.9f} {span:.9f} {ares:.9f} "
                f"{max_range:.3f} 0.01 0 {B} {r} 0 {lp} {op} "
                f"0 0 0 0 0 {timestamps[t]:.6f} nohost "
                f"{timestamps[t]:.6f}\n")
