"""The optimal-gauge star cell on the CPU: its kind's traced rehearsal, the
readers of its three per-layer metrics, faults planted where a star's
numbers come from, and its plain reference against the program's condense
in float64.

The cell runs here at a small request (two or four candidates, the graph
at full size); on the card at its own (``perfbench/calibrate.py``).
"""

from __future__ import annotations

import dataclasses
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cg_mrslam_tpu_torch.utils import metrics as M  # noqa: E402
from perfbench.lib import harness  # noqa: E402
from perfbench.lib import trace as TR  # noqa: E402

CELL = "hospital_2robot_cap1024_star128.star_optimal"
NEW = ["star_marginal_pct", "marginal_active_pct", "marginal_hvp_roofline"]
SMALL = {"batch": 2, "pool_batches": 2, "sample": 4}
SEED = 2**35 + 17


def small_spec(**traffic) -> harness.Spec:
    spec = harness.Spec(ROOT, CELL)
    spec.traffic = dict(spec.traffic, **SMALL, **traffic)
    return spec


def reader(name):
    return harness.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                               name)


def _span(device):
    return {"calls": 1, "host_s": device, "self_s": device,
            "device_s": device}


TOTALS = {None: {"star.optimal": _span(8.0), "condense.marginals": _span(6.0),
                 "marginal.hvp": _span(0.5)},
          "star.optimal": {"condense.marginals": _span(6.0)}}
COUNTS = {"loop.pcg.marginal.iters": 384, "loop.pcg.marginal.active": 300,
          "loop.pcg.marginal.problems": 1200, "host_read.pcg.marginal": 48}
WORK = {"band": "pcg", "vertex_slots": 1024, "edge_slots": 896,
        "own_edges": 852, "candidates": 128, "columns": 384}


def _hvp_bytes(b, c, n, e, listed):
    return (3 * b * e * 9 * 4 + b * e * 2 * 4 + 2 * b * c * n * 3 * 4
            + listed * 4 + (b * n + 1) * 4 + b * n)


WANT = {"star_marginal_pct": 75.0, "marginal_active_pct": 25.0,
        "marginal_hvp_roofline": 100.0 * 384 * _hvp_bytes(
            128, 384, 1024, 896, 2 * 852 * 128) / 3.35e12 / 0.5}


@pytest.fixture
def hand_store(monkeypatch):
    monkeypatch.setattr(M, "span_totals",
                        lambda under=None: TOTALS.get(under, {}))
    monkeypatch.setattr(M, "counts", lambda: dict(COUNTS))


def _run(traced=True, device="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(
        trace=SimpleNamespace(n_ticks=1) if traced else None,
        device_name=device, cell=SimpleNamespace(work=lambda: dict(WORK)))


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_hand_built_store(name, hand_store):
    assert reader(name).read(_run()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_untraced(name, hand_store):
    assert reader(name).read(_run(traced=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_without_the_spans(name, monkeypatch):
    """A program without the star's spans and counters (the fleet cells'
    stores, or a commit before them) reads nothing."""
    monkeypatch.setattr(M, "span_totals", lambda under=None: {
        "band.pcg": _span(1.0), "pcg.hvp": _span(0.1)})
    monkeypatch.setattr(M, "counts", lambda: {"loop.pcg.cg.iters": 256})
    assert reader(name).read(_run()) is None


def test_roofline_needs_a_published_peak(hand_store):
    assert reader("marginal_hvp_roofline").read(_run(device="cpu")) is None


@pytest.fixture
def cpu_profiler(monkeypatch):
    """The harness's profiler on the CPU alone (no card here)."""
    monkeypatch.setattr(TR, "_activities",
                        lambda: [torch.profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(TR, "warm", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_traced_rehearsal_reads_the_cells_metrics(cpu_profiler):
    torch.set_num_threads(2)
    spec = small_spec(trace_skip=0, trace_ticks=1)
    M.reset()
    result, _ = harness.run_cell(spec, SEED, 0.0, True, time.perf_counter(),
                                 device="cpu")
    M.reset()
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]
    # no published peak for a CPU: the roofline reads nothing here
    assert set(got) == {m["name"] for m in spec.per_layer} - {
        "marginal_hvp_roofline"}
    for m in got.values():
        assert math.isfinite(m["value"])
    assert 50 < got["star_marginal_pct"]["value"] < 100
    assert 0 < got["marginal_active_pct"]["value"] <= 100
    # a star reads the candidates once, and its loops look at their flags
    assert got["host_reads_per_tick"]["value"] > 1


# -- faults where a star's numbers come from ------------------------------


def _moved_boundary(real):
    """The settle's answer with the newest boundary vertex moved 0.1 m."""
    def solve(g, *a, **k):
        out = real(g, *a, **k)
        poses = out.poses.clone()
        poses[..., 1006, 0] += 0.1
        return dataclasses.replace(out, poses=poses)
    return solve


def _widened(real):
    """Marginal covariances 1% too wide."""
    def marginals(*a, **k):
        return 1.01 * real(*a, **k)
    return marginals


@pytest.mark.parametrize("entry,fault", [("optimize_auto", _moved_boundary),
                                         ("marginal_covariance_auto",
                                          _widened)])
def test_a_broken_star_is_not_correct(entry, fault, monkeypatch):
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    monkeypatch.setattr(gn, entry, fault(getattr(gn, entry)))
    torch.set_num_threads(2)
    result, checks = harness.run_cell(small_spec(), SEED, 0.0, False,
                                      time.perf_counter(), device="cpu")
    assert result["correct"] is False, checks


# -- the reference ------------------------------------------------------------


def test_reference_is_the_programs_condense_in_float64(monkeypatch):
    """The reference's stars and the program's ``condense_optimal`` in
    float64, at budgets where its CG solves run to their tolerances (376
    iterations each here), on the cell's graph with two candidates."""
    from cg_mrslam_tpu_torch.core.graph import PoseGraph, unpack_info
    from cg_mrslam_tpu_torch.mr import condensed
    from cg_mrslam_tpu_torch.solver.chain import chain_order
    from perfbench.kinds import optimal_star as kind
    from perfbench.reference import condense as ref

    monkeypatch.setattr(condensed, "SETTLE_PCG_ITERS", 2048)
    monkeypatch.setattr(condensed, "MARGINAL_PCG_ITERS", 2048)
    torch.set_num_threads(4)
    spec = small_spec()
    host, meta = kind.build_pool(spec.config, spec.traffic, SEED)
    boundary = kind.boundary_of(host, meta, 0, 2)
    own = host["emask"][0] & (host["e_owner"][0] == 0)
    g = PoseGraph(**{k: torch.as_tensor(v[0]).to(torch.float64)
                     if v.dtype == np.float32 else torch.as_tensor(v[0])
                     for k, v in host.items()})
    order = chain_order(torch.as_tensor(meta["v_owner"]),
                        torch.as_tensor(meta["v_remote"]), g.vmask)
    star, u = condensed.condense_optimal(g, torch.as_tensor(boundary),
                                         torch.ones(2, dtype=torch.bool),
                                         torch.as_tensor(own), order)
    want = ref.stars({k: host[k][:1] for k in ref.gnr.FIELDS}, own[None],
                     boundary, np.ones(2, bool))
    # the CG loops stop at their tolerances (‖r‖² below 1e-12 for the
    # marginals' columns, 1e-8 for the settle), which leave ~1e-7 of
    # the uncertainty and of Ω (read: 8.4e-8, 1.3e-8) and ~1e-9 of z
    np.testing.assert_allclose(u.numpy(), want["u"][0], rtol=5e-7)
    assert int(star.gauge) == int(boundary[want["gauge"][0]])
    ok = want["valid"][0]
    assert np.abs(star.z.numpy()[ok] - want["z"][0][ok]).max() < 1e-8
    om, wom = unpack_info(star.info).numpy()[ok], want["omega"][0][ok]
    assert np.abs(om - wom).max() / np.abs(wom).max() < 1e-7


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import perfbench.reference.condense; "
            "import perfbench.kinds.optimal_star; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)
    for name in ("cg_mrslam_tpu_torch", "cg_mrslam_tpu", "jax"):
        assert name not in tops


def test_the_boundary_is_the_newest_closure_vertices():
    from perfbench.kinds import optimal_star as kind

    spec = harness.Spec(ROOT, CELL)
    host, meta = kind.build_pool(spec.config, dict(spec.traffic,
                                                   pool_batches=1), SEED)
    b = kind.boundary_of(host, meta, 0, spec.traffic["batch"])
    assert len(set(b.tolist())) == 128
    assert (meta["v_owner"][b] == 0).all()
    assert (np.diff(meta["v_remote"][b]) < 0).all()
    assert b[0] == 1006
