"""The harness on the CPU: a small rehearsal of every cell, the result's
line, the control and the planted faults, and ``BENCHMARK.json``'s rules.

The cells run here at a small batch (their graphs at full size); on the
card the same code runs them at their own size (``cuda`` tests, and
``perfbench/calibrate.py`` for the readings the limits come from).
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib import calibration, harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"batch": 2, "pool_batches": 2, "sample": 4}
SEED = 2**31 + 77


def small_spec(workload: str) -> harness.Spec:
    spec = harness.Spec(ROOT, workload)
    spec.traffic = dict(spec.traffic, **SMALL)
    return spec


def rehearse(spec, seed=SEED):
    """A whole run on the CPU but its look for a card: ``(result,
    checks)``."""
    return harness.run_cell(spec, seed, 0.0, False, time.perf_counter(),
                            device="cpu")


@pytest.fixture(scope="module", params=CELLS)
def rehearsal(request):
    torch.set_num_threads(2)
    spec = small_spec(request.param)
    return (spec,) + rehearse(spec)


def test_rehearsal_is_correct(rehearsal):
    _, result, checks = rehearsal
    assert result["correct"] is True
    for c in checks:
        assert c["ok"], c


def test_result_line_keys(rehearsal):
    spec, result, checks = rehearsal
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    batch = spec.traffic["batch"]
    assert result["attempted"] >= batch and result["attempted"] % batch == 0
    assert result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    wanted = {m["name"] for m in spec.end_to_end if m["name"] != "tick_p90_ms"}
    assert wanted <= set(result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert list(result["checks"]) == [c["name"] for c in checks]
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_same_seed_same_inputs():
    spec = small_spec(CELLS[0])
    a = spec.kind.build_pool(spec.config, spec.traffic, SEED)[0]
    b = spec.kind.build_pool(spec.config, spec.traffic, SEED)[0]
    c = spec.kind.build_pool(spec.config, spec.traffic, SEED + 1)[0]
    assert np.array_equal(a["poses"], b["poses"])
    assert not np.array_equal(a["poses"], c["poses"])


# -- the control and the faults ------------------------------------------


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    """The reference in TF32, in the program's place, reads above every
    cell's limits (three seeds, a small batch)."""
    spec = small_spec(workload)
    for seed in (1, 2, 3):
        rec = calibration.readings(spec, seed, 0.0, "cpu")
        assert all(rec["program"][k] <= spec.limits[k]["limit"]
                   for k in rec["control"]), rec
        assert any(rec["control"][k] > spec.limits[k]["limit"]
                   for k in rec["control"]), rec


def _unchanged(real):
    return lambda g, *a, **k: g


def _half(real):
    def solve(g, *a, **k):
        out = real(g, *a, **k)
        h = g.poses.shape[0] // 2
        return dataclasses.replace(out, poses=torch.cat(
            [out.poses[:h], g.poses[h:]]))
    return solve


def _altered(real):
    def solve(g, *a, **k):
        out = real(g, *a, **k)
        poses = out.poses.clone()
        poses[:, 1, 0] += 0.1
        return dataclasses.replace(out, poses=poses)
    return solve


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_solve_is_not_correct(workload, fault, monkeypatch):
    """The rest of a run, with the timed path broken underneath: a solve
    that returns its state unchanged, half of the batch left unsolved, an
    answer altered where it is produced."""
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    monkeypatch.setattr(gn, "optimize_auto", fault(gn.optimize_auto))
    spec = small_spec(workload)
    spec.traffic["batch"] = 4
    result, checks = rehearse(spec)
    assert result["correct"] is False, checks


# -- the process: no card, nothing forbidden, only the committed files ----


def test_run_without_a_card_prints_no_result(tmp_path):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       env={"CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path),
                            "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_needs_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_setup_loads_no_jax(workload):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from perfbench.lib import harness
spec = harness.Spec(Path({str(ROOT)!r}), {workload!r})
spec.traffic = dict(spec.traffic, batch=1, pool_batches=1)
cell = spec.kind.Cell(spec.config, spec.traffic, spec.limits, 3, device="cpu")
cell.setup()
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert "cg_mrslam_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "cg_mrslam_tpu"}


# -- BENCHMARK.json -------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_and_files():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "workloads"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits_at_the_cell_size(workload):
    """The control at the cell's own batch and graphs, on three seeds: the
    program within every limit, the reference in TF32 above one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = harness.Spec(ROOT, workload)
    for seed in (101, 202, 303):
        rec = calibration.readings(spec, seed, 1.0, "cuda")
        assert all(rec["program"][k] <= spec.limits[k]["limit"]
                   for k in rec["control"]), rec
        assert any(rec["control"][k] > spec.limits[k]["limit"]
                   for k in rec["control"]), rec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_unsolved_at_the_cell_size(workload, monkeypatch):
    """Half of every tick's batch left unsolved, at the cell's own batch and
    sample, on three seeds: ``correct`` false each time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    monkeypatch.setattr(gn, "optimize_auto", _half(gn.optimize_auto))
    spec = harness.Spec(ROOT, workload)
    for seed in (404, 505, 606):
        result, checks = harness.run_cell(spec, seed, 1.0, False,
                                          time.perf_counter())
        assert result["correct"] is False, checks
