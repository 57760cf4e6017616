"""Virtual network: connectivity gating + loss injection for multi-robot
exchange.

Port of ``cg_mrslam_tpu/mr/network.py``: the three modalities of the
reference's ``robotsInRange`` (``graph_comm.cpp:70-101``) as mask
constructors — REAL (always connected), SIM (ground-truth distance below
the comm range, 5 m by default), BAG (a ping from that robot within the
last 10 s) — plus drop injection and the ping record/replay log. Masks are
bool tensors on the device of their input (the CPU for host-made ones).
"""

from __future__ import annotations

import numpy as np
import torch


def real_connectivity(n_robots: int) -> torch.Tensor:
    """All pairs connected (REAL modality)."""
    return ~torch.eye(n_robots, dtype=torch.bool)


def sim_connectivity(gt_positions: torch.Tensor,
                     comm_range: float = 5.0) -> torch.Tensor:
    """Range-gated pairs from ground-truth positions ``[R, 2]``."""
    d = torch.linalg.norm(gt_positions[:, None, :] - gt_positions[None, :, :],
                          dim=-1)
    m = d < comm_range
    return m & ~torch.eye(gt_positions.shape[0], dtype=torch.bool,
                          device=gt_positions.device)


def bag_connectivity(last_ping_age: torch.Tensor,
                     ping_timeout: float = 10.0) -> torch.Tensor:
    """Ping-replay gating: ``last_ping_age [R, R]`` seconds since robot j
    last pinged robot i."""
    m = last_ping_age < ping_timeout
    return m & ~torch.eye(last_ping_age.shape[0], dtype=torch.bool,
                          device=last_ping_age.device)


def inject_drops(mask: torch.Tensor, generator: torch.Generator,
                 drop_prob: float) -> torch.Tensor:
    """Randomly sever live links (fault injection; the reference's UDP
    drops silently and the protocol must converge regardless). The bits
    come from a ``torch.Generator``, not the reference's JAX key."""
    keep = torch.rand(mask.shape, generator=generator,
                      device=mask.device) < 1.0 - drop_prob
    return mask & keep


class PingLog:
    """Connectivity beacon record/replay — the ``comm_publisher`` node +
    BAG modality. ``record(t, i, j)`` logs that robot ``i`` heard robot
    ``j`` at time ``t``; :meth:`connectivity` replays the log into a mask
    for any time."""

    def __init__(self, n_robots: int):
        self.n = n_robots
        self.events: list[tuple[float, int, int]] = []

    def record(self, t: float, hearer: int, sender: int) -> None:
        self.events.append((float(t), int(hearer), int(sender)))

    def record_from_positions(self, t: float, positions,
                              comm_range: float = 5.0) -> None:
        """Beacon emulation: every pair in radio range pings."""
        pos = np.asarray(positions)
        for i in range(self.n):
            for j in range(self.n):
                if i != j and np.hypot(*(pos[i] - pos[j])) < comm_range:
                    self.record(t, i, j)

    def connectivity(self, t: float, timeout: float = 10.0) -> torch.Tensor:
        """BAG-modality mask at time ``t``: ping age < timeout."""
        age = np.full((self.n, self.n), np.inf)
        for (ts, i, j) in self.events:
            if ts <= t:
                age[i, j] = min(age[i, j], t - ts)
        return bag_connectivity(torch.as_tensor(age, dtype=torch.float32),
                                timeout)
