"""The solver's spans and counters (``utils/metrics.span``, ``count``).

* With no profiler running nothing is recorded, and every band's solve
  (batched and batch-1) gives the same bits with a profiler running as
  without one.
* Under ``torch.profiler`` on the CPU, a PCG solve through
  ``optimize_auto`` records the band split, the band, each Gauss–Newton
  iteration's parts and the CG body's parts with their parents; the GN
  and CG counters match the iterations and the budget; the host reads
  counted are the loop's looks, the split's (or the batch-1 chain
  check's) predicate and the segment table's width; the spans are user
  annotations in the profiler's own events, so the benchmark's trace
  (``perfbench/lib/trace.py``) holds them among the host's operations.
* ``masked_loop``'s counters on a planted body whose problems stop at
  known iterations.
"""

import sys
from pathlib import Path

import pytest
import torch

from cg_mrslam_tpu_torch.sim import graphs as GR
from cg_mrslam_tpu_torch.solver import gauss_newton as gn
from cg_mrslam_tpu_torch.solver.spd import CHECK, masked_loop
from cg_mrslam_tpu_torch.utils import metrics as M

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.lib import trace as TR  # noqa: E402

CPU = torch.device("cpu")
GN_ITERS = 2
CG = 16                 # two looks a GN iteration
B = 2


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _clean_store():
    M.reset()
    yield
    M.reset()


def _graph(band, single):
    if band.startswith("dense"):
        g, order = GR.build_batch(3, device=CPU), None
    elif band == "chain":
        g, order = GR.build_hospital_batch(B, n=320, closures=12,
                                           device=CPU), None
    else:
        g, order, _ = GR.build_merged_batch(B, device=CPU)
    if single:
        g = gn._take(g, 0)
    return g, order


def _solve(band, g, order):
    return gn.optimize_auto(g, GN_ITERS, order=order, pcg_iters=CG,
                            chain_cg_iters=CG,
                            chol=band == "dense_chol").poses


def test_nothing_recorded_without_a_profiler():
    g, order = _graph("pcg", False)
    _solve("pcg", g, order)
    assert M.counts() == {} and M.span_totals() == {}
    assert M.span("a") is M.span("b")
    M.count("x", 3)
    assert M.counts() == {}


@pytest.mark.parametrize("single", [False, True], ids=["batch", "one"])
@pytest.mark.parametrize("band", ["dense", "dense_chol", "chain", "pcg"])
def test_tracing_keeps_the_bits(band, single):
    g, order = _graph(band, single)
    off = _solve(band, g, order)
    with _profile():
        on = _solve(band, g, order)
    assert M.span_totals()["band." + band.split("_")[0]]["calls"] == 1
    assert torch.equal(off, on)


BAND_SPANS = ("gn.linearize", "gn.precond", "gn.solve", "gn.update",
              "pcg.hvp", "pcg.update", "pcg.precond_apply")


@pytest.mark.parametrize("single", [False, True], ids=["batch", "one"])
def test_pcg_solve_spans_and_counters(single):
    g, order = _graph("pcg", single)
    with _profile() as prof:
        with torch.profiler.record_function(TR.TICK):
            _solve("pcg", g, order)
    tot = M.span_totals()
    assert tot == M.span_totals()                 # the store is kept
    assert set(tot) == {"solver.optimize_auto", "band.pcg", *BAND_SPANS,
                        *(() if single else ("solver.split",))}
    assert tot["solver.optimize_auto"]["calls"] == tot["band.pcg"]["calls"] \
        == 1
    c = M.counts()
    iters = c["loop.pcg.cg.iters"]
    looks = c["loop.pcg.cg.looks"]
    assert c["gn.iters.pcg"] == GN_ITERS
    assert iters == GN_ITERS * CG and looks == GN_ITERS * CG // CHECK
    assert c["loop.pcg.cg.problems"] == looks * (1 if single else B)
    assert 0 < c["loop.pcg.cg.active"] <= c["loop.pcg.cg.problems"]
    split = {"host_read.chainable": 1} if single else {"host_read.split": 1}
    assert {k: v for k, v in c.items() if k.startswith("host_read.")} == {
        "host_read.pcg.cg": looks, "host_read.segment_table": 1, **split}
    # parents: every band span inside the entry, the split and the band;
    # the CG body's spans inside the GN solve, nothing inside them
    nest = ["solver.optimize_auto", "solver.split", "band.pcg"]
    if single:
        nest.remove("solver.split")
    for i, outer in enumerate(nest):
        inner = M.span_totals(under=outer)
        assert set(inner) == set(tot) - set(nest[:i + 1])
        assert all(inner[k]["calls"] == tot[k]["calls"] for k in inner)
    assert set(M.span_totals(under="gn.solve")) == {
        "pcg.hvp", "pcg.update", "pcg.precond_apply"}
    assert M.span_totals(under="pcg.hvp") == {}
    assert M.span_totals(under="pcg.update") == {}
    for name in ("gn.linearize", "gn.precond", "gn.solve", "gn.update"):
        assert tot[name]["calls"] == GN_ITERS
    assert tot["pcg.hvp"]["calls"] == tot["pcg.precond_apply"]["calls"] \
        == iters
    assert tot["pcg.update"]["calls"] == 2 * iters
    for t in tot.values():
        assert 0 <= t["self_s"] <= t["host_s"] == t["device_s"]
    if not single:
        band = tot["band.pcg"]["host_s"]
        split = tot["solver.split"]
        assert split["self_s"] == pytest.approx(split["host_s"] - band)
    # the profiler's own events: user annotations, in the trace's host ops
    events = prof.profiler.kineto_results.events()
    ann = {e.name() for e in events if e.is_user_annotation()}
    assert set(tot) <= ann
    host = {h[2] for h in TR.Trace(events).host}
    assert set(tot) <= host


def test_dense_solve_reads_nothing_on_the_host():
    g, order = _graph("dense_chol", False)
    with _profile():
        _solve("dense_chol", g, order)
    tot = M.span_totals()
    assert set(tot) == {"solver.optimize_auto", "band.dense", "gn.linearize",
                        "gn.solve", "gn.update"}
    assert set(M.span_totals(under="band.dense")) == {
        "gn.linearize", "gn.solve", "gn.update"}
    assert M.counts() == {"gn.iters.dense": GN_ITERS}


# problem e takes the step at iterations 1 .. STOPS[e] (1-based)
STOPS = [3, 9, 17, 40]


def _planted(budget, graph=False):
    stops = torch.tensor(STOPS)

    def body(s):
        k, steps = s
        active = k + 1 <= stops
        return (k + 1, steps + active.to(steps.dtype)), active

    return masked_loop(body, (torch.zeros((), dtype=torch.long),
                              torch.zeros(len(STOPS), dtype=torch.long)),
                       budget, "planted", graph=graph)


@pytest.mark.parametrize("budget,iters,looks,active", [
    (64, 48, 6, 3 + 2 + 1 + 1 + 1 + 0),   # stops at the look at 48
    (20, 20, 2, 3 + 2),                   # the budget ends it
    (0, 0, 0, 0)])
def test_masked_loop_counters(budget, iters, looks, active):
    with _profile():
        k, steps = _planted(budget)
    assert int(k) == iters
    assert steps.tolist() == [min(s, iters) for s in STOPS]
    c = M.counts()
    assert (c["loop.planted.iters"], c["loop.planted.looks"],
            c["loop.planted.active"], c["loop.planted.problems"],
            c["host_read.planted"]) == (iters, looks, active,
                                        looks * len(STOPS), looks)


@pytest.mark.parametrize("budget,iters", [(64, 48), (20, 20), (0, 0)])
def test_masked_loop_graph_is_the_plain_loop_off_the_card(budget, iters):
    """``graph=True`` on CPU tensors runs the loop as written: the same
    exit, the same state, the same counters."""
    with _profile():
        want = _planted(budget)
    plain = M.counts()
    M.reset()
    with _profile():
        got = _planted(budget, graph=True)
    assert int(got[0]) == int(want[0]) == iters
    assert torch.equal(got[1], want[1])
    assert M.counts() == plain
