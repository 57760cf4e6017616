"""The readers of the program's own spans and counters
(``perfbench/lib/program_trace.py`` and the six metrics that use it):
each against a hand-built run, nothing from an untraced run or from a
program that records no spans, and a CPU rehearsal of both cells with
``--trace 1`` whose line carries every metric of its cell.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cg_mrslam_tpu_torch.utils import metrics as M  # noqa: E402
from perfbench.lib import harness  # noqa: E402
from perfbench.lib import trace as TR  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["host_reads_per_tick", "split_ms_per_tick", "cg_iters_per_gn",
       "cg_active_pct", "pcg_hvp_pct", "dense_assembly_pct"]
SEED = 2**33 + 91


def reader(name):
    return harness.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                               name)


def _span(host, device, self_s=None):
    return {"calls": 1, "host_s": host, "self_s": host if self_s is None
            else self_s, "device_s": device}


# a hand-built store of two traced ticks: totals, and the totals inside
# each band span
TOTALS = {None: {"solver.optimize_auto": _span(9.0, 8.0),
                 "solver.split": _span(8.5, 8.0, self_s=0.05),
                 "band.pcg": _span(8.4, 7.9),
                 "pcg.hvp": _span(4.0, 5.0),
                 "band.dense": _span(0.5, 0.4),
                 "gn.linearize": _span(0.3, 0.25)},
          "band.pcg": {"pcg.hvp": _span(4.0, 5.0),
                       "gn.linearize": _span(0.2, 0.15)},
          "band.dense": {"gn.linearize": _span(0.1, 0.1)}}
COUNTS = {"host_read.pcg.cg": 320, "host_read.split": 2,
          "host_read.segment_table": 2, "gn.iters.pcg": 10,
          "loop.pcg.cg.iters": 2560, "loop.pcg.cg.active": 4000,
          "loop.pcg.cg.problems": 6400, "gn.iters.dense": 5}
WANT = {"host_reads_per_tick": 162.0, "split_ms_per_tick": 25.0,
        "cg_iters_per_gn": 256.0, "cg_active_pct": 62.5,
        "pcg_hvp_pct": 100.0 * 5.0 / 7.9,
        "dense_assembly_pct": 100.0 * 0.1 / 0.4}


@pytest.fixture
def hand_store(monkeypatch):
    monkeypatch.setattr(M, "span_totals",
                        lambda under=None: TOTALS.get(under, {}))
    monkeypatch.setattr(M, "counts", lambda: dict(COUNTS))


def _run(traced=True):
    return SimpleNamespace(trace=SimpleNamespace(n_ticks=2) if traced
                           else None)


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_hand_built_store(name, hand_store):
    assert reader(name).read(_run()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_untraced(name, hand_store):
    assert reader(name).read(_run(traced=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_without_the_programs_spans(name, monkeypatch):
    monkeypatch.delattr(M, "span_totals")
    assert reader(name).read(_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_nothing_from_an_empty_store(name):
    M.reset()
    assert reader(name).read(_run()) is None


def test_reads_are_zero_where_the_band_has_none(monkeypatch):
    """A dense tick reads nothing on the host: 0, not nothing."""
    monkeypatch.setattr(M, "span_totals", lambda under=None: {
        "band.dense": _span(1.0, 1.0)} if under is None else {})
    monkeypatch.setattr(M, "counts", lambda: {"gn.iters.dense": 5})
    assert reader("host_reads_per_tick").read(_run()) == 0.0
    for name in NEW[1:]:
        assert reader(name).read(_run()) is None


def test_each_new_metric_is_listed():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        assert per_layer[name]["source"] in ("program_span",
                                             "program_counter")
        assert per_layer[name]["moves"] == "solves_per_s"


@pytest.fixture
def cpu_profiler(monkeypatch):
    """The harness's profiler on the CPU alone (no card here)."""
    monkeypatch.setattr(TR, "_activities",
                        lambda: [torch.profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(TR, "warm", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traced_rehearsal_reads_every_metric(workload, cpu_profiler):
    torch.set_num_threads(2)
    spec = harness.Spec(ROOT, workload)
    spec.traffic = dict(spec.traffic, batch=2, pool_batches=2, sample=4,
                        trace_skip=0, trace_ticks=1)
    M.reset()
    result, _ = harness.run_cell(spec, SEED, 0.0, True, time.perf_counter(),
                                 device="cpu")
    M.reset()
    assert result["correct"] is True
    got = result["metrics"]
    mine = [m["name"] for m in spec.per_layer if m["name"] in NEW]
    assert mine and set(mine) <= set(got)
    for name in mine:
        assert math.isfinite(got[name]["value"]), name
    if workload.endswith("fleet_pcg"):
        assert set(mine) == set(NEW) - {"dense_assembly_pct"}
        assert got["cg_iters_per_gn"]["value"] <= spec.config["solve"][
            "pcg_iters"]
        assert 0 < got["cg_active_pct"]["value"] <= 100
        assert 0 < got["pcg_hvp_pct"]["value"] < 100
    else:
        assert set(mine) == {"host_reads_per_tick", "dense_assembly_pct"}
        assert got["host_reads_per_tick"]["value"] == 0.0
        assert 0 < got["dense_assembly_pct"]["value"] < 100
