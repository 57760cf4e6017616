"""Workload kind ``fleet_solve``: a fleet back end's batched pose-graph
updates.

B robots' pose graphs live on the card. Each tick runs every robot's
per-keyframe update, ``optimize(5)`` of the reference system
(``graph_slam.cpp:561-574``), as one batched call into the program's live
solver entry, ``solver.gauss_newton.optimize_auto``, with the keyword
arguments the configuration names; the tick ends when the optimized poses
are in host memory. The loop is closed: a tick starts when the last one
returned.

Set-up builds on the host, from the seed, a pool of ``pool_batches × B``
distinct perturbed starts (``perfbench/gen``), copies it to the card, and
warms the cell's shapes with one tick (with the traffic's ``warm_solve``
overrides, such as fewer CG iterations: the same shapes and kernels, a
shorter loop). Tick ``t`` solves the pool's batch
``t mod pool_batches``.

The check, after the window: a sample drawn from the seed of the graphs
the window solved, each compared with the plain reference
(``perfbench/reference``) run on the same start — the largest gap of any
live pose, in m and rad, per graph, and its quantiles over the sample —
with the band every call took and the count of graphs with a non-finite
pose.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.gen import hospital
from perfbench.reference import gauss_newton as reference

SEED_MASK = (1 << 64) - 1


def _u(seed: int, *salt: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed & SEED_MASK, *salt])


def build_pool(config: dict, traffic: dict, seed: int):
    """The host pool ``(graphs, meta)``: ``pool_batches × batch`` copies of
    the configuration's snapshot, each with its own pose noise."""
    g = config["graph"]
    total = int(traffic["batch"]) * int(traffic.get("pool_batches", 1))
    s = int(np.random.default_rng(_u(seed)).integers(0, 1 << 62))
    return hospital.snapshot(
        total, hospital.DATA / g["snapshot"], g["vertex_slots"],
        g["edge_slots"], seed=s, sigma_xy=g["noise"]["xy_m"],
        sigma_th=g["noise"]["theta_rad"])


def pose_gaps(a: np.ndarray, b: np.ndarray, vmask: np.ndarray) -> np.ndarray:
    """Per graph, the largest gap between two sets of poses ``[S, N, 3]``
    over the live vertices: ``|Δx|``, ``|Δy|`` (m) and the wrapped
    ``|Δθ|`` (rad)."""
    d = np.abs(a - b)
    d[..., 2] = np.abs((a[..., 2] - b[..., 2] + np.pi) % (2 * np.pi) - np.pi)
    d = np.where(vmask[..., None], d, 0.0)
    return d.max(axis=(1, 2))


def gap_stats(gaps: np.ndarray) -> dict:
    return {"gap_p50": float(np.quantile(gaps, 0.5)),
            "gap_p90": float(np.quantile(gaps, 0.9))}


class Cell:
    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int,
                 device="cuda"):
        self.config = config
        self.traffic = traffic
        self.limits = limits
        self.seed = seed
        self.device = torch.device(device)
        self.batch = int(traffic["batch"])
        self.pool_batches = int(traffic.get("pool_batches", 1))
        self.band = traffic["band"]
        self.solve_kw = dict(config["solve"])
        self.iterations = int(self.solve_kw.pop("iterations"))
        self.order_kind = self.solve_kw.pop("order", None)
        self.outputs: list = []

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from cg_mrslam_tpu_torch.core.graph import PoseGraph
        from cg_mrslam_tpu_torch.solver import gauss_newton as gn

        self.gn = gn
        t0 = time.perf_counter()
        self.host, self.meta = build_pool(self.config, self.traffic,
                                          self.seed)
        t1 = time.perf_counter()
        dev = {k: torch.as_tensor(v).to(self.device)
               for k, v in self.host.items()}
        b = self.batch
        self.batches = [
            PoseGraph(**{k: v[i * b:(i + 1) * b] for k, v in dev.items()})
            for i in range(self.pool_batches)]
        order = None
        if self.order_kind == "owner_keyframe":
            from cg_mrslam_tpu_torch.solver.chain import chain_order
            order = chain_order(
                torch.as_tensor(self.meta["v_owner"], device=self.device),
                torch.as_tensor(self.meta["v_remote"], device=self.device),
                dev["vmask"][0])
        elif self.order_kind is not None:
            raise ValueError(f"unknown order {self.order_kind!r}")
        self.solve_kw["order"] = order
        before = dict(gn.BAND_CALLS)
        t2 = time.perf_counter()
        self._solve(self.batches[0],
                    **self.traffic.get("warm_solve", {})).cpu()
        t3 = time.perf_counter()
        print(f"set-up: pool of {len(self.host['poses'])} graphs "
              f"{t1 - t0:.3f} s, copy {t2 - t1:.3f} s, warm tick "
              f"{t3 - t2:.3f} s", file=sys.stderr, flush=True)
        warm = {k: v - before.get(k, 0) for k, v in gn.BAND_CALLS.items()
                if v != before.get(k, 0)}
        print("band: " + ", ".join(f"{e} -> {band}: {n}" for (e, band), n
                                   in sorted(warm.items())) +
              f" (the cell names {self.band})", file=sys.stderr, flush=True)
        self.calls_before = dict(gn.BAND_CALLS)

    def _solve(self, g, **overrides):
        return self.gn.optimize_auto(g, self.iterations,
                                     **dict(self.solve_kw, **overrides)).poses

    # -- the window -----------------------------------------------------
    def tick(self, t: int) -> None:
        self.outputs.append(
            self._solve(self.batches[t % self.pool_batches]).cpu())

    def units(self) -> int:
        """Graphs solved a tick."""
        return self.batch

    def attempted(self) -> int:
        return len(self.outputs) * self.batch

    def failed(self) -> int:
        return sum(int((~torch.isfinite(o).flatten(1).all(1)).sum())
                   for o in self.outputs)

    def work(self) -> dict:
        """What one graph's solve is: its band, live poses and edges and GN
        iterations (the readers' roofline counts)."""
        return {"band": self.band,
                "poses": int(self.host["n_vertices"][0]),
                "edges": int(self.host["n_edges"][0]),
                "iterations": self.iterations}

    # -- the check ------------------------------------------------------
    def free(self) -> None:
        """Drop the program's state on the card."""
        self.batches = None
        self.solve_kw["order"] = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def sample(self):
        """``(pool indices [S], answers [S, N, 3])``: graphs solved in the
        window, drawn from the seed."""
        total = len(self.outputs) * self.batch
        k = min(int(self.traffic.get("sample", 64)), total)
        pick = np.sort(np.random.default_rng(_u(self.seed, 1)).choice(
            total, k, replace=False))
        tick, slot = pick // self.batch, pick % self.batch
        pool = (tick % self.pool_batches) * self.batch + slot
        answers = np.stack([self.outputs[t][s].double().numpy()
                            for t, s in zip(tick, slot)])
        return pool, answers

    def reference(self, pool: np.ndarray, tf32: bool = False) -> np.ndarray:
        """The plain reference's poses for the pool's graphs ``pool``."""
        graphs = {k: self.host[k][pool] for k in reference.FIELDS}
        block = int(self.config["reference"]["block"])
        return reference.optimize(graphs, self.iterations,
                                  device=self.device, tf32=tf32,
                                  block=block).numpy()

    def check(self) -> list:
        """Each number compared, with its limit: the graphs of the window
        solved in another band than the cell names, the graphs with a
        non-finite pose, and the sample's gap quantiles against the
        reference."""
        self.free()
        other = sum(v - self.calls_before.get(k, 0)
                    for k, v in self.gn.BAND_CALLS.items()
                    if k[1] != self.band)
        pool, answers = self.sample()
        ref = self.reference(pool)
        self.compared = (pool, ref)
        stats = gap_stats(pose_gaps(answers, ref, self.host["vmask"][pool]))
        checks = [("other_band_calls", other, 0),
                  ("nonfinite_graphs", self.failed(), 0)]
        checks += [(k, v, self.limits[k]["limit"]) for k, v in stats.items()]
        return [{"name": n, "value": v, "limit": lim, "ok": v <= lim}
                for n, v, lim in checks]
