"""Workload kind ``optimal_star``: a robot's condensed-graph answers to a
peer's request under the uncertainty-minimizing gauge.

One robot's merged view lives on the card. Each tick answers one request
for a star on ``batch`` boundary vertices (the newest robot-0 vertices of
the snapshot's inter-robot closures, newest first, as ``star_inputs``
orders them) with the program's ``mr.condensed.condense_optimal`` over the
robot's own edges in the (owner, keyframe) slot order: every boundary
vertex is a candidate gauge, condensed once in one batch, and the first
minimum of the total uncertainty wins. The tick ends when the star and
the uncertainties are in host memory. The loop is closed: a tick starts
when the last one returned.

Set-up builds on the host, from the seed, a pool of ``pool_batches``
perturbed copies of the snapshot (``perfbench/gen``: the drift a graph
carries between its last ``optimize(5)`` and an exchange round), copies
it to the card and warms one whole star at the cell's shape. Tick ``t``
condenses the pool's graph ``t mod pool_batches``.

The check, after the window: ``sample // batch`` stars drawn from the seed
among the window's pool graphs, each compared with the plain reference
(``perfbench/reference/condense.py``) on the same graph: every
candidate's uncertainty, the regret of the program's gauge in the
reference's uncertainties, the program's star against the reference's
star at the program's gauge (``z`` in m and rad, ``Ω`` per edge); with the
bands every call took and the count of condenses with a non-finite
number.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench.gen import hospital
from perfbench.reference import condense as reference
from perfbench.reference.gauss_newton import FIELDS

SEED_MASK = (1 << 64) - 1


def _u(seed: int, *salt: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed & SEED_MASK, *salt])


def build_pool(config: dict, traffic: dict, seed: int):
    """The host pool ``(graphs, meta)``: ``pool_batches`` copies of the
    configuration's snapshot, each with its own pose noise."""
    g = config["graph"]
    total = int(traffic.get("pool_batches", 1))
    s = int(np.random.default_rng(_u(seed)).integers(0, 1 << 62))
    return hospital.snapshot(
        total, hospital.DATA / g["snapshot"], g["vertex_slots"],
        g["edge_slots"], seed=s, sigma_xy=g["noise"]["xy_m"],
        sigma_th=g["noise"]["theta_rad"])


def boundary_of(graphs: dict, meta: dict, robot: int, k: int) -> np.ndarray:
    """The ``k`` newest vertices of ``robot`` (by keyframe index, newest
    first) that an inter-robot closure of the graph touches."""
    owner = meta["v_owner"]
    ij, live = graphs["e_ij"][0], graphs["emask"][0]
    inter = live & (owner[ij[:, 0]] != owner[ij[:, 1]])
    ends = np.unique(ij[inter])
    mine = ends[owner[ends] == robot]
    newest = mine[np.argsort(-meta["v_remote"][mine], kind="stable")]
    if len(newest) < k:
        raise ValueError(f"the snapshot has {len(newest)} closure vertices "
                         f"of robot {robot}; the request names {k}")
    return newest[:k].astype(np.int32)


def pose_gaps(a: dict, b: dict, vmask: np.ndarray) -> dict:
    """The gaps of the stars ``a`` (the program's, or the control's) to
    the reference's ``b`` over the same graphs: per candidate the relative
    gap of the total uncertainty; per star the regret of ``a``'s gauge in
    ``b``'s uncertainties (``b``'s at that gauge over its least, less 1)
    and the largest gap of ``z`` (m, rad) to ``b``'s star at ``a``'s gauge;
    per edge of that star the relative Frobenius gap of ``Ω``. ``vmask``
    (the graphs' live vertices) is the kind's interface and not needed:
    every number is of a boundary vertex."""
    del vmask
    s = a["u"].shape[0]
    pick = np.arange(s), a["gauge"]
    ub = b["u"]
    finite = np.isfinite(ub)
    uncert = np.abs(a["u"] - ub)[finite] / np.abs(ub[finite])
    regret = ub[pick] / ub.min(axis=1) - 1.0
    zb, ob = b["z_all"][pick], b["omega_all"][pick]
    both = a["valid"] & b["valid_all"][pick]
    d = np.abs(a["z"] - zb)
    d[..., 2] = np.abs((a["z"][..., 2] - zb[..., 2] + np.pi) % (2 * np.pi)
                       - np.pi)
    z = np.where(both[..., None], d, 0.0).reshape(s, -1).max(axis=1)
    info = (np.linalg.norm((a["omega"] - ob)[both], axis=(-2, -1))
            / np.linalg.norm(ob[both], axis=(-2, -1)))
    return {"uncert": uncert, "regret": regret, "z": z, "info": info}


def _q90(x: np.ndarray) -> float:
    return float(np.quantile(x, 0.9)) if x.size else float("nan")


def gap_stats(gaps: dict) -> dict:
    return {"uncert_gap_p90": _q90(gaps["uncert"]),
            "gauge_regret": float(np.max(gaps["regret"])),
            "z_gap_max": float(np.max(gaps["z"])),
            "info_gap_p90": _q90(gaps["info"])}


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
        star = config["star"]
        if star["gauge_mode"] != "optimal" or self.batch > int(
                star["star_edges_cap"]):
            raise ValueError(f"the cell asks for {self.batch} candidates "
                             f"under the {star['gauge_mode']!r} gauge")
        self.robot = int(star["robot"])
        self.outputs: list = []

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from cg_mrslam_tpu_torch.core.graph import PoseGraph, own_edge_mask
        from cg_mrslam_tpu_torch.mr import condensed
        from cg_mrslam_tpu_torch.solver import gauss_newton as gn
        from cg_mrslam_tpu_torch.solver.chain import chain_order

        self.gn = gn
        self.condense_optimal = condensed.condense_optimal
        t0 = time.perf_counter()
        self.host, self.meta = build_pool(self.config, self.traffic,
                                          self.seed)
        self.boundary = boundary_of(self.host, self.meta, self.robot,
                                    self.batch)
        own = self.host["emask"] & (self.host["e_owner"] == self.robot)
        self.host["own"] = own
        t1 = time.perf_counter()
        dev = {k: torch.as_tensor(v).to(self.device)
               for k, v in self.host.items() if k != "own"}
        self.graphs = [PoseGraph(**{k: v[i] for k, v in dev.items()})
                       for i in range(self.pool_batches)]
        self.own = [own_edge_mask(g, self.robot) for g in self.graphs]
        self.order = chain_order(
            torch.as_tensor(self.meta["v_owner"], device=self.device),
            torch.as_tensor(self.meta["v_remote"], device=self.device),
            dev["vmask"][0])
        self.slots = torch.as_tensor(self.boundary, device=self.device)
        self.valid = torch.ones(self.batch, dtype=torch.bool,
                                device=self.device)
        before = dict(gn.BAND_CALLS)
        t2 = time.perf_counter()
        self._star(0)
        t3 = time.perf_counter()
        print(f"set-up: pool of {self.pool_batches} graphs {t1 - t0:.3f} s, "
              f"copy {t2 - t1:.3f} s, warm star {t3 - t2:.3f} s",
              file=sys.stderr, flush=True)
        warm = {k: v - before.get(k, 0) for k, v in gn.BAND_CALLS.items()
                if v != before.get(k, 0)}
        print("band: " + ", ".join(f"{e} -> {band}: {n}" for (e, band), n
                                   in sorted(warm.items())) +
              f" (the cell names {self.band})", file=sys.stderr, flush=True)
        self.calls_before = dict(gn.BAND_CALLS)

    def _star(self, i: int) -> dict:
        star, u = self.condense_optimal(self.graphs[i], self.slots,
                                        self.valid, self.own[i], self.order)
        # one copy of everything to the host: the tick's end
        flat = torch.cat([u, star.z.flatten(), star.info.flatten(),
                          star.valid.to(u.dtype),
                          star.gauge.reshape(1).to(u.dtype)]).cpu()
        k = self.batch
        return {"u": flat[:k], "z": flat[k:4 * k].reshape(k, 3),
                "info": flat[4 * k:10 * k].reshape(k, 6),
                "valid": flat[10 * k:11 * k] > 0.5,
                "gauge_vertex": int(flat[11 * k])}

    # -- the window -----------------------------------------------------
    def tick(self, t: int) -> None:
        self.outputs.append(self._star(t % self.pool_batches))

    def units(self) -> int:
        """Condenses a tick: one per candidate gauge."""
        return self.batch

    def attempted(self) -> int:
        return len(self.outputs) * self.batch

    def _failed(self, o: dict) -> int:
        """The condenses of one star with a non-finite number: candidates
        whose uncertainty is not finite, and the winner where its star
        is not."""
        bad = ~torch.isfinite(o["u"])
        ok = (torch.isfinite(o["z"]).all(1) & torch.isfinite(o["info"]).all(1)
              | ~o["valid"])
        if not bool(ok.all()):
            bad[self.gauge_slot(o)] = True
        return int(bad.sum())

    def failed(self) -> int:
        return sum(self._failed(o) for o in self.outputs)

    def gauge_slot(self, o: dict) -> int:
        hit = np.flatnonzero(self.boundary == o["gauge_vertex"])
        return int(hit[0]) if hit.size else 0

    def work(self) -> dict:
        """What one star is: its band, the graph's vertex and edge slots,
        its own edges, the candidates and the marginals' columns a
        candidate (the readers' roofline counts)."""
        return {"band": self.band,
                "vertex_slots": int(self.host["poses"].shape[1]),
                "edge_slots": int(self.host["e_ij"].shape[1]),
                "own_edges": int(self.host["own"][0].sum()),
                "candidates": self.batch,
                "columns": 3 * self.batch}

    # -- the check ------------------------------------------------------
    def free(self) -> None:
        """Drop the program's state on the card."""
        self.graphs = self.own = self.order = None
        self.slots = self.valid = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def sample(self):
        """``(pool indices [S], answers)``: the stars of ``S`` distinct pool
        graphs the window condensed, drawn from the seed; each the first
        tick that condensed it."""
        first = {}
        for t in range(len(self.outputs)):
            first.setdefault(t % self.pool_batches, t)
        k = max(1, int(self.traffic.get("sample", 2 * self.batch))
                // self.batch)
        k = min(k, len(first))
        pool = np.sort(np.random.default_rng(_u(self.seed, 1)).choice(
            sorted(first), k, replace=False))
        outs = [self.outputs[first[p]] for p in pool]
        info = np.stack([o["info"].double().numpy() for o in outs])
        xx, xy, xt, yy, yt, tt = np.moveaxis(info, -1, 0)
        omega = np.stack([np.stack([xx, xy, xt], -1),
                          np.stack([xy, yy, yt], -1),
                          np.stack([xt, yt, tt], -1)], -2)
        answers = {"u": np.stack([o["u"].double().numpy() for o in outs]),
                   "gauge": np.asarray([self.gauge_slot(o) for o in outs]),
                   "z": np.stack([o["z"].double().numpy() for o in outs]),
                   "omega": omega,
                   "valid": np.stack([o["valid"].numpy() for o in outs])}
        return pool, answers

    def reference(self, pool: np.ndarray, tf32: bool = False) -> dict:
        """The plain reference's stars for the pool's graphs ``pool``."""
        graphs = {k: self.host[k][pool] for k in FIELDS}
        return reference.stars(
            graphs, self.host["own"][pool], self.boundary,
            np.ones(self.batch, bool), device=self.device, tf32=tf32,
            block=int(self.config["reference"]["block"]))

    def check(self) -> list:
        """Each number compared, with its limit: the calls of the window
        solved in another band than the cell names, the condenses with a
        non-finite number, and the sample's gaps to the reference."""
        self.free()
        other = sum(v - self.calls_before.get(k, 0)
                    for k, v in self.gn.BAND_CALLS.items()
                    if k[1] != self.band)
        pool, answers = self.sample()
        ref = self.reference(pool)
        self.compared = (pool, ref)
        stats = gap_stats(pose_gaps(answers, ref, self.host["vmask"][pool]))
        checks = [("other_band_calls", other, 0),
                  ("nonfinite", self.failed(), 0)]
        checks += [(k, v, self.limits[k]["limit"]) for k, v in stats.items()]
        return [{"name": n, "value": v, "limit": lim, "ok": v <= lim}
                for n, v, lim in checks]
