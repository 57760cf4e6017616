"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (nothing is caught; any failure ends the run with a traceback):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build the score-volume kernels K1 and K2, K2's fused ``known_cap`` pair
   and the two timing probes (``csrc/score_volume.cu``, one nvcc); print
   its ``ptxas -v`` report and the card's maximum SM clock;
3. ``srslam``: the single-robot default deployment (40 x 20 m hospital
   world, seed 0, 2 loops, 360 beams, 10 m range, capacity 512/2048, close
   grid 30 m at 0.025 m, LC grid 70 m at 0.1 m) through ``SingleRobotSlam``
   on the card, up to capacity - 2 keyframes, with K1's launch counts set
   to 0 just before and read just after; checks launches = 3 per keyframe,
   finite chi2, at least one accepted closure, ATE below the odometry-only
   ATE, every keyframe on the dense Cholesky band; prints ATE, the solver
   backend per keyframe and keyframe latency p50/p99 per bucket;
4. K1 at its three main-path shapes (close, near, loop), on the inputs of
   the first call of each shape in phase 3 whose volume depends on where
   the points land (a grid that is not constant under kept points, and a
   score that varies along both offset axes): against its plain PyTorch
   version (rtol 1e-5, atol 1e-6), timed as ``ms`` (CUDA events over
   back-to-back wrapper calls), ``device_ms`` (the calls captured into a
   CUDA graph and replayed: device time only) and ``host_us`` (the host's
   enqueue per call), beside the bytes bound; then the two timing probes
   (``no_gather``, ``const_cells``: wrong by design, each held to its own
   plain version) on the same inputs, timed the same way. The log line of
   each also gives the issue floor at the card's maximum SM clock (computed,
   so not in the JSON record);
5. the first 20 ``srslam`` keyframes replayed on the CPU (plain versions),
   poses against the card's;
6. ``cg_mrslam``: the in-process multi-robot default deployment (2 robots,
   the same world and sensors, robot r on seed 7r, comm range 5 m,
   ``MRConfig`` defaults) through ``MultiRobotSim`` on the card until both
   robots stop keyframing at capacity - 4, with K1's and K2's counts set to
   0 just before and read just after; checks foreign vertices on every
   robot, at least one accepted inter-robot closure and one spliced star,
   finite chi2, K2 launches = 4 per robot per exchange round (every one the
   fused pair), no probe launched, K1 launches = 3 per keyframe, keyframes on the dense Cholesky band and condense on the
   chain or PCG band, per-robot ATE below the odometry-only ATE and a
   median cross-robot pose agreement under 0.6 m (``tests/test_mrslam.py``'s
   bar); prints those, condenses by band, keyframe and exchange-round time
   p50/p99 (host clock, the card synchronized around each) and the split of
   a round (CUDA events, no synchronization added);
7. K2's pair at the level-0 and refine lattices of phase 6, on live
   captured inputs, against its plain version (rtol 1e-5, atol 1e-6), timed
   and probed as in phase 4;
8. phase 6 replayed on the CPU (plain versions) up to the first exchange
   round in which a robot accepts an inter-robot closure (so combos were
   received, parked vertices matched by the global search into buffered
   hypotheses, and those voted in): every round's outcomes — vertices,
   foreign and parked vertices, buffered hypotheses, inter-robot closures,
   star edges — equal to the card's, own keyframe poses within 1e-3 m /
   rad;
9. the command line (``python -m cg_mrslam_tpu_torch``, each command a
   subprocess in ``chiprun_out/cli/``, on the card; each must exit 0):
   (a) ``srslam`` at the default deployment: as many keyframe lines as
   phase 3 had keyframes, closures within ±1; its ``.g2o`` loads through
   both parsers alike (ids, edges, poses within 1e-6); the loaded graph's
   chi2 equals the last printed chi2 (1e-3 relative, or the print's
   rounding); its ATE within 0.02 m
   of phase 3's; its map's sides a multiple of 128 and its occupied share
   in (0.001, 0.2), the share of its occupied cells within 0.1 m of a wall
   printed; the same scans integrated at the ground-truth keyframe poses
   hold ``tests/test_occupancy.py``'s bar (≥ 90% of the occupied cells
   within 0.1 m of a wall, occupied share in (0.001, 0.2)); the metrics JSONL
   written; the largest pose difference against phase 3 printed. Then
   ``integrate`` (ms, peak memory), ``g2o.save`` and ``load`` (native and
   Python) timed on that graph. (b) ``srslam --ticks 800``, then
   ``SingleRobotSlam.resume`` of its ``.g2o`` in this process fed the rest
   of the route (as ``tests/test_resume.py`` does): the reloaded vertices
   and poses, finite chi2, ATE below the odometry-only ATE. (c) ``srslam
   --carmen`` on the route's first 400 ticks written with the port's
   ``carmen.write``: keyframes and a ``.g2o``. (d) ``cg_mrslam --nRobots 2
   --ticks 300``: two ``.g2o`` files and two maps, an accepted inter-robot
   closure, each graph holding the peer's namespaced keyframes;
10. the per-process UDP deployment (``cg_mrslam --idRobot r``, in
   ``chiprun_out/udp/``): robot 1 as a subprocess (``python -m
   cg_mrslam_tpu_torch``), robot 0 through ``cli.main`` in this process once
   robot 1's loop has started, both at the full width of phase 6 (capacity
   512, 360 beams, the default grids, ``MRConfig``'s range and caps), cut
   to ``UDP_TICKS`` ticks paced at ``TICK_SECONDS``, on a free base port
   found by a probe; K1's and K2's counts set to 0 just before robot 0 and
   read just after. Checks: both exit 0 on the native transport; messages
   received, none undecodable; foreign vertices on both; at least one
   accepted inter-robot closure and one spliced star edge in all; both
   ``.g2o`` files load through the native parser with every edge's chi2
   finite; the median cross-robot agreement (robot r's copy of a
   constrained peer vertex against the peer's own, from the two files)
   under 0.6 m; each robot's own-keyframe ATE below its odometry-only ATE;
   in robot 0's process K1 launches = 3 per keyframe, K2 = 4 per global
   search (a keyframe or a comm round), every one the fused pair, no
   probe. Prints the wall time, the time a tick, keyframes, messages and
   bytes sent and received, and the dropped counters of each robot;
11. the matcher's other modes and the exchange's two options, on live
   inputs of phases 3 and 6, each on the card and on the CPU (plain
   versions) with the same inputs: (a) ``global_match`` of ``srslam``
   keyframe n/2 against the LC grid of its ±10 neighbours from a guess
   moved by (1.0 m, 0.5 m, 0.6 rad), and (b) ``loop_closure_match_
   hierarchical`` from one moved by (0.8 m, -0.6 m, 0.3 rad): both find
   the keyframe's pose to one finest lattice step, card and CPU poses
   within 1e-4 and scores within 1e-5, K2's single-grid entry launched
   once per level (4 and 3), never the pair; (c) ``loop_closure_match`` of
   the first keyframe that closed a loop, regions at its pose and its loop
   partners' on one grid of their neighbourhoods: one K1 launch, card and
   CPU alike; (d) K2's single-grid entry at each level's shape of (a) and
   (b), and K1 at (c)'s shape, on the calls' captured inputs, against the
   plain version, timed and probed as in phase 4 (records with ``"pair":
   false``, the phase's launches, ``launches_main_path`` 0: no deployment
   calls these modes by default); (e) every global search of phase 6 that
   accepted a match, replayed through ``try_match_parked`` with
   ``detect_robot_in_range`` on the card, the first 12 also on the CPU
   (card and CPU decide alike and match the same poses); prints, for the
   first 12 and for all, how many the gate passes, how many matches are
   wrong (over 1 m from the ground-truth relative pose) and how many of
   those it passes; (f) ``build_star(gauge_mode="optimal")`` at phase 6's
   first star (at most 8 candidates): the same gauge on the card and the
   CPU, K and the time; (g) ``spanning_tree_guess`` (as many sweeps as
   live vertices) then ``optimize_lm`` (15 iterations) of phase 3's final
   graph with its free poses perturbed (σ 0.3 m, 0.1 rad, seed 0): equal
   hop distances, tree poses within 1e-4, chi2 lower after LM on both, LM
   poses within 1e-3;
12. the parallel layer, live ingestion and the viz export (files in
   ``chiprun_out/phase12/``): (a) ``maps/viz.py``'s ``trajectory``,
   ``laser_map_points``, ``map_to_odom`` and ``render_png`` on phase 3's
   final state, on the card and on a CPU copy: outputs within 1e-5, the PGM
   of the size its bounds give, at most 0.1% of its pixels different; (b)
   the first ``STREAM_TICKS`` (400) ticks of phase 3's route sent by a
   thread over localhost to a ``UdpJsonSource`` (one geometry header,
   absolute odometry dead-reckoned in float64, the route's scans; at most
   16 datagrams in flight) and ``run_slam_on_source`` on the card: the
   datagrams received equal those sent, the keyframes phase 3's over those
   ticks, their poses within 1e-3 of phase 3's; (c) ``FleetSim`` at phase
   6's full width over phase 6's scans, up to ``FLEET_EXTRA_TICKS`` (30)
   ticks past phase 6's first inter-robot closure, K1's and K2's counts set
   to 0 just before and read just after: every round's tick and outcomes
   equal to phase 6's through that closure, own-keyframe ATE within 0.05 m of
   phase 6's at the last round, a spliced star, K1 = 3 per keyframe, K2 = 4
   per robot per round, every one the pair, no probe; prints the buckets,
   the condense bands and the round time p50/p99 beside phase 6's over the
   same rounds; (d) ``sharded_optimize`` and ``sharded_optimize_pcg`` of 64
   loop graphs (64 vertices, 128 edges) in one process over NCCL and in two
   processes on ``cuda:0`` over gloo (NCCL refuses two ranks on one card):
   poses within 5e-3 of the one-process solves of each graph (on the CPU),
   each solve repeated bit for bit; (e) ``fleet_round_sharded`` on two gloo processes
   on ``cuda:0`` from phase 6's states before its first inter-robot closure
   (saved under ``chiprun_out/phase12/``) against ``fleet_round`` in this
   process: integer leaves equal, floats within ``tests/test_fleet.py``'s
   bar; and the merged 1024 fixture's chain-preconditioned PCG solve (5 GN
   iterations of 96 CG) on the card, chi2 within 1% of the CPU's every
   iteration. Every process group is joined with a 120 s timeout;
13. the JAX bench's workloads (``bench.py``) at its sizes, each timed as its
   ``timed`` does (one warm-up, then the median of distinct inputs) beside
   solves/s, records in ``chiprun_out/phase13/bench.json``: (a) dense GN×5
   (SPD inverse) of ``build_batch(1024)``: every chi2 below its start, 8
   graphs within 1e-4 of batch-1 CPU solves, repeats bit-equal; the dense
   reference point (16 hospital graphs of 1024 poses), chi2 printed; (b) the
   chain band on ``build_hospital_batch(512)`` at ``bench.py``'s ``CHAIN_KW``:
   dropped 0, mean chi2 below 0.05 of its start, the median distance from
   the exact optimum within :data:`CHAIN_POSES`, two graphs' chi2 against
   batch-1 CPU solves (:data:`CHAIN_CONVERGED`), two graphs with 12 closures
   in float64 within
   :data:`CHAIN_POSES_F64` of the CPU's, repeats bit-equal; graph 0 with
   ``cg_schedule`` and with ``freeze_precond`` (the guard's redos and the
   distance from the optimum printed), each below 1e-3 of its start; (c) the merged fixture, 512 graphs (the
   PCG band, as ``auto_backend`` picks; 8 CG; mean chi2 below 1e-3 of its
   start, two graphs within 1% of batch-1 CPU solves, element 0 beside the
   dense CPU oracle 12.796) and 4096 as 8 chunks of 512; (d) PCG on one
   65,536-pose graph (96 CG), chi2 below 1e-3 of its start; (e) the optimal
   gauge at phase 6's first star by ``condense_optimal``: each candidate's
   uncertainty within 1e-4 of its own condense on the card, the CPU's gauge,
   the time beside the per-candidate loop's; then the benchmark cell's star
   (128 candidates on the merged fixture): the PCG band only, every number
   finite, its time and peak memory; (f) ``utils/sol.report()``,
   each fraction in (0, 1.05]; (g) ``srslam`` at capacity 1024
   (``bench.py``'s latency row) to :data:`LATENCY_TICKS`: K1 3 per keyframe,
   finite chi2, a closure, ATE below odometry, at least 60 keyframes in
   bucket 1024 and those off the dense band; latency p50/p99 per bucket;
   (h) the PCG band's Hessian-vector kernel pair (``csrc/pcg_hvp.cu``) at
   ``fleet_pcg``'s shapes (2048 merged graphs under the chain order) and at
   a batch-1 call of 48 columns: against its plain version (1e-5 of each
   row's ``Σ|Jᵀ||Ω||J||x|``), timed as phase 4 times K1, beside the plain
   version and the function's bytes bound (``tools/bench_pcg_hvp.py``'s
   record), with its build time and ``ptxas -v`` report; added to the
   ``kernels`` record, with the pair's launches on the main path; (i) the
   PCG preconditioner's cyclic-reduction kernel (``csrc/cr_apply.cu``) at
   ``fleet_pcg``'s shapes (2048 graphs, one column) and the star's (128
   graphs, 384 columns), on a 65,536-pose graph (its buffer in device
   memory) and in float64: against its plain version (the error against
   the same factor's float64 solve at most twice the plain version's and
   1e-6 of the scale; in float64 within 1e-9), timed beside the plain
   version and its bytes-or-operations bound (``tools/bench_cr_apply.py``'s
   record); added to the ``kernels`` record with its main-path launches;
   (j) the PCG loop's two vector updates (``csrc/cg_update.cu``) at
   ``fleet_pcg``'s shapes (2048 graphs of 1024 slots), the star's (128
   graphs × 384 columns), on a batch-1 65,536-pose system (the split path)
   and in float64: against their plain version on systems some frozen
   before the call and some freezing in it (within 1e-5 of the scale in
   float32, 1e-12 in float64; the same done flags; frozen systems
   untouched bit for bit; repeats bit-equal; bit-equal to the CPU
   rehearsal of their arithmetic on some systems: ``tools/
   bench_cg_update.check``), then timed beside the plain version and
   their bytes bound (``tools/bench_cg_update.py``'s records), with the
   build time and ``ptxas -v`` report; added to the ``kernels`` record
   with their main-path launches.

The pair's main-path launches: in phase 6, in phase 12's merged solve on
the card and in phase 13 (c), (d) and (e)'s 128-candidate star on the
card, its launch count is set
to 0 just before and read just after, beside the CG iterations that the PCG
band's loops ran there (``loop.pcg.cg.iters`` + ``loop.pcg.marginal.iters``,
counted with the solver's loop counters on and no profiler); each stretch
checks that the two are equal and not 0, and the ``kernels`` records of
(h) carry the counts (``launches_main_path``, ``launches_by_stretch``).
The same stretches count the cyclic-reduction kernel's launches against
the preconditioner solves their CG loops make on the card (one per
iteration, one before each PCG loop, two before each chain-band loop, one
per chain preconditioner's ``Hc⁻¹U``); each checks the two equal, and (i)'s
records carry the counts. They count the CG update kernels' calls too,
each checked to be twice the PCG band's CG iterations (update A and update
B once each an iteration), which (j)'s records carry.

The card's line comes again just before the ``kernels`` JSON record (every
kernel and probe record), which is the line before last; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is available.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 1e-5, 1e-6
N_CPU_KEYFRAMES = 20
# the CPU replay of phase 8 stops at the first inter-robot closure; it
# fails if that comes later than this many exchange rounds
MAX_CPU_ROUNDS = 60
# tests/test_mrslam.py's bar on the median cross-robot disagreement
MAX_AGREEMENT_M = 0.6
# a volume that varies by less than this along an offset axis cannot tell a
# kernel that reads the right cells from one that does not
MIN_SPREAD = 100 * ATOL
SHAPES = {"close": (65, 12, 12), "near": (17, 3, 3), "loop": (65, 15, 5)}
# K2's lattices on the multi-robot path, by stride: level 0 of the
# hierarchical search at step 8, the refine levels at steps 4, 2, 1
STRIDED = {"level0": 8, "refine4": 4, "refine2": 2, "refine1": 1}
REPLACES = "cg_mrslam_tpu/ops/correlate.py:189 (_make_kernel_v3 via " \
           "pallas_score_volume, :477; pallas_call at :454)"
REPLACES_K2 = "cg_mrslam_tpu/ops/correlate.py:505 (pallas_score_volume_" \
              "strided; body _make_kernel_v3 :189, pallas_call at :454)"
# the timing probes: the TPU probe each stands for
REPLACES_PROBE = {
    "no_gather": "cg_mrslam_tpu/ops/correlate.py:226 (_make_kernel_x1, "
                 "timing probe; pallas_call at :454)",
    "const_cells": "cg_mrslam_tpu/ops/correlate.py:257 (_make_kernel_x2, "
                   "timing probe; pallas_call at :454)"}
SOURCE = "cg_mrslam_tpu_torch/csrc/score_volume.cu"
ROOT = Path(__file__).resolve().parent
CLI_DIR = ROOT / "chiprun_out" / "cli"
# the resumed run of phase 9: saved at this tick, resumed in this process
RESUME_TICK = 800
UDP_DIR = ROOT / "chiprun_out" / "udp"
# phase 10: the route cut to this many ticks, each tick paced to start no
# earlier than start + t * TICK_SECONDS, with room above the time a tick
# takes free running while the two robots exchange (128-150 ms on average
# on one H100, and at a pace of 0.2 s robot 0 still averaged 201-208 ms;
# PERF.md §5): a process that overruns its pace falls behind its peer, and
# their simulated clocks drift apart
UDP_TICKS = 400
TICK_SECONDS = 0.3
UDP_START_DELAY = 20.0
# phase 11: keyframe k's map is the scans of its ±MAP_WINDOW neighbours;
# the guesses of (a) and (b) are moved by these offsets (x, y, θ), each a
# whole number of finest lattice steps, inside each mode's window
MAP_WINDOW = 10
PLANTED = (1.0, 0.5, 0.6)
PLANTED_LC = (0.8, -0.6, 0.3)
# the strides of each mode's hierarchical levels at the LC grid's 0.1 m
GLOBAL_LEVELS = {8: "level0", 4: "refine4", 2: "refine2", 1: "refine1"}
LC_LEVELS = {4: "level0", 2: "refine2", 1: "refine1"}
LC_REGIONS = 4
N_MATCHES = 12        # (e): accepted global searches also gated on the CPU
STAR_CAP = 8          # (f): at most this many optimal-gauge candidates
STAR_CELL_K = 128     # 13 (e): the benchmark cell's optimal-gauge request
LM_ITERS = 15
PERTURB = (0.3, 0.1)  # (g): σ of the free poses' noise, m and rad
# phase 12: the stream's ticks, FleetSim's ticks past phase 6's first
# inter-robot closure, the sharded solves' batch (graphs, vertices, edges)
PHASE12_DIR = ROOT / "chiprun_out" / "phase12"
STREAM_TICKS = 400
FLEET_EXTRA_TICKS = 30
SHARD_BATCH = (64, 64, 128)
GROUP_TIMEOUT = 120.0
MERGED = ROOT / "tests" / "fixtures" / "merged_2robot_1024.npz"
# phase 13: the JAX bench's workloads at its sizes (bench.py): the chain
# operating point (CHAIN_KW, :60), the merged PCG budget (:76), the dense
# CPU oracle of merged element 0
PHASE13_DIR = ROOT / "chiprun_out" / "phase13"
CHAIN_KW = dict(loop_cap=64, cg_iters=24, cg_tol=1e-4)
MERGED_PCG_ITERS = 8
MERGED_ORACLE = 12.796
# (g)'s depth, cut by time from the bench's 2300 ticks: phase 13 has ~150 s,
# (a)-(f) take ~55 s, and a keyframe in bucket 1024 takes 1.1-1.9 s on one
# H100 (the first 511 keyframes ~26 s); 2130 ticks is the shortest depth with
# the 60 keyframes in bucket 1024 the phase must run (63: keyframe 512 comes
# at tick 1897 and keyframe 574 at tick 2119, fixed by the odometry)
LATENCY_TICKS = 2130
# the median over a batch of float32 chain solves of each graph's largest
# distance from the exact optimum (the ring's true poses: its measurements
# are exact and vertex 0 is fixed), m and rad. From ~0.5 at the start, a
# float32 solve ends anywhere from 0.002 to 0.05 from it as the rounding
# goes, and about one in a hundred far off (128 graphs on the CPU: median
# 0.007, p90 0.017, p99 0.43): CG's 1e-4 residual and the capacitance
# inverse's float32 polish leave the ring's weakest modes (ROADMAP, Next)
CHAIN_POSES = 0.02
# five float64 GN iterations of the chain band on graphs with 12 closures
# against the CPU's: rounding only (tests/test_torch_chain_f64.py; with 48
# closures the capacitance inverse's polish turns on the last bits)
CHAIN_POSES_F64 = 1e-6
# the second check, chi2 of a chain solve against another: within 1%, or
# both below 1e-4 of the start chi2, the reference's own bar of a converged
# solve at this scale (tests/test_chain_solver.py::
# test_bench_geometry_f32_convergence): below it both sit at the float32
# noise floor, where a graph's chi2 moves over orders of magnitude with the
# rounding
CHAIN_CONVERGED = 1e-4


def log(*a):
    print(*a, flush=True)


# the PCG Hessian-vector pair's launches and the PCG band's CG iterations
# in each counted stretch of the main path (see the module docstring)
HVP_STRETCHES: dict = {}


@contextlib.contextmanager
def hvp_counted(name: str):
    """Count the PCG band's Hessian-vector kernel pair's launches over a
    stretch that runs on the card only, beside the CG iterations the
    band's loops run there (``solver.spd.masked_loop``'s counters, on for
    the stretch without a profiler); checks that every iteration launched
    the pair once, and stores both under ``HVP_STRETCHES[name]``. The
    band's loops run as written over the stretch: a replayed graph
    launches the pair without a call that the wrapper counts.

    The preconditioner's cyclic-reduction kernel is counted beside it
    (``cr_launches``) against the solves the CG loops on the card make
    (``cr_applies``): one per iteration, and before each loop one in the
    PCG band and two in the chain band (its warm start and first
    residual), and one per chain preconditioner built with loop columns
    (its ``Hc⁻¹U``); the stretch checks that the two are equal. The CG
    update kernels' calls (``cg_update_launches``) are checked against
    twice the PCG band's iterations: update A and update B each once an
    iteration."""
    from cg_mrslam_tpu_torch.ops.cg_update import CG_UPDATE
    from cg_mrslam_tpu_torch.ops.cr_apply import CR_APPLY
    from cg_mrslam_tpu_torch.ops.pcg_hvp import PCG_HVP
    from cg_mrslam_tpu_torch.solver import chain as CH
    from cg_mrslam_tpu_torch.solver import pcg as P
    from cg_mrslam_tpu_torch.utils import metrics as M

    counted = collections.Counter()
    applies = collections.Counter()
    count, loop, ch_loop, setup = (M.count, P.masked_loop, CH.masked_loop,
                                   CH._precond_setup)

    def counting(fn, before_loop):
        def run(body, state, budget, loop_name, graph=False):
            k0 = counted[f"loop.{loop_name}.iters"]
            out = fn(body, state, budget, loop_name)
            if state[1].is_cuda:
                applies[loop_name] += (counted[f"loop.{loop_name}.iters"]
                                       - k0 + before_loop)
            return out
        return run

    def counted_setup(td, loops):
        if td.D.is_cuda and loops[-1].shape[-1]:
            applies["chain.setup"] += 1
        return setup(td, loops)

    M.count = lambda key, n=1: counted.update({key: n})
    P.masked_loop = counting(loop, 1)
    CH.masked_loop = counting(ch_loop, 2)
    CH._precond_setup = counted_setup
    PCG_HVP.launches = 0
    CR_APPLY.launches = 0
    CG_UPDATE.launches = 0
    try:
        yield
    finally:
        M.count, P.masked_loop, CH.masked_loop, CH._precond_setup = (
            count, loop, ch_loop, setup)
    iters = counted["loop.pcg.cg.iters"] + counted["loop.pcg.marginal.iters"]
    cr = sum(applies.values())
    HVP_STRETCHES[name] = {"launches": PCG_HVP.launches, "cg_iters": iters,
                           "cr_launches": CR_APPLY.launches,
                           "cr_applies": cr,
                           "cg_update_launches": CG_UPDATE.launches}
    log(f"pcg_hvp: {name}: {PCG_HVP.launches} launches, {iters} PCG "
        f"iterations ({counted['loop.pcg.cg.iters']} solve, "
        f"{counted['loop.pcg.marginal.iters']} marginal); cr_apply: "
        f"{CR_APPLY.launches} launches, {cr} solves {dict(applies)}; "
        f"cg_update: {CG_UPDATE.launches} calls")
    assert PCG_HVP.launches == iters > 0, (name, PCG_HVP.launches,
                                           dict(counted))
    assert CR_APPLY.launches == cr > iters, (name, CR_APPLY.launches,
                                             dict(applies))
    assert CG_UPDATE.launches == 2 * iters, (name, CG_UPDATE.launches,
                                             iters)


def plain_of(args, ty, tx):
    """The plain version of a K1 or K2 call on its wrapper's arguments."""
    from cg_mrslam_tpu_torch.ops import correlate as K

    if len(args) == 11 and args[10] is not None:
        return K.volume_pair_plain(*args[:6], ty, tx, args[10])
    return K.volume_plain(*args[:6], ty, tx)


def k1_name(args) -> str:
    """K1's call ``(grids, gidx, ix, iy, keep, count, ry, rx)`` by shape."""
    key = (args[2].shape[1], args[6], args[7])
    return next(k for k, v in SHAPES.items() if v == key)


def k2_name(args) -> str:
    """K2's call ``(..., ny, nx, sy, sx)`` by stride."""
    return next(k for k, v in STRIDED.items() if v == args[8])


def live_volumes(grids, gidx, keep) -> torch.Tensor:
    """``[B]``: volume ``b`` keeps points and its grid is not constant."""
    flat = grids.flatten(1)
    varied = (flat.amax(1) > flat.amin(1))[gidx.long()]
    return varied & keep.flatten(1).any(1)


def spreads(vol, live):
    """Largest spread of the live volumes of ``vol [B,T,Dy,Dx]`` (or a
    pair's ``[B,2,T,Dy,Dx]``) along Dy and along Dx (0 when no volume is
    live)."""
    if not bool(live.any()):
        return 0.0, 0.0
    v = vol[live].flatten(1, -3)
    return (float((v.amax(2) - v.amin(2)).max()),
            float((v.amax(3) - v.amin(3)).max()))


class Capture:
    """Stands in for the kernel wrapper inside ``matcher.search``. It
    launches through the real wrapper, so the launch counts are the
    wrapper's own, and keeps a copy of the inputs of the first call of each
    shape whose volume depends on where the points land — on inputs where
    every score is the same constant, a kernel that ignored its offsets or
    misread its grid index would still agree with the plain version."""

    def __init__(self, kernel, name_of, names):
        self.kernel = kernel
        self.name_of = name_of
        self.names = names
        self.calls = {}      # shape name -> kernel inputs
        self.pending = {}    # shape name -> (kernel inputs, output)
        self.keyframe = {}   # shape name -> keyframe it was captured at

    @property
    def armed(self) -> bool:
        return len(self.calls) < len(self.names)

    def __call__(self, *args):
        out = self.kernel(*args)
        name = self.name_of(args)
        if self.armed and name not in self.calls:
            self.pending[name] = (tuple(a.clone() if torch.is_tensor(a)
                                        else a for a in args), out.clone())
        return out

    def settle(self, keyframe: int) -> None:
        """After a keyframe or an exchange round (outside its clock): keep
        the pending calls that are live."""
        for name, (args, out) in self.pending.items():
            live = live_volumes(args[0], args[1], args[4])
            if min(spreads(out, live)) >= MIN_SPREAD:
                self.calls[name] = args
                self.keyframe[name] = keyframe
        self.pending.clear()


def deployment_config(n_robots: int):
    """The CLI defaults of ``srslam`` (1 robot) and ``cg_mrslam`` (2)."""
    from cg_mrslam_tpu_torch.config import (Config, MatcherConfig, MRConfig,
                                            SlamConfig)

    return Config(
        slam=SlamConfig(linear_update=0.25, angular_update=math.pi / 4,
                        min_inliers=7, window_loop_closure=10,
                        inlier_threshold=2.0),
        mr=MRConfig(n_robots=n_robots, max_score_mr=0.15, min_inliers_mr=5,
                    window_mr_loop_closure=10, sim_comm_range=5.0),
        close_matcher=MatcherConfig(extent=30.0, resolution=0.025,
                                    kernel_radius=0.2, max_score=0.15),
        lc_matcher=MatcherConfig(extent=70.0, resolution=0.1,
                                 kernel_radius=0.5, max_score=0.15),
        max_vertices=512, max_edges=2048)


def srslam_setup():
    from cg_mrslam_tpu_torch.sim import world as W

    cfg = deployment_config(1)
    world = W.hospital_world(40.0, 20.0, seed=0)
    wps = W.corridor_waypoints(40.0, 20.0, 0, 2)
    fov = 2 * np.pi * 0.75
    traj = W.simulate_robot(world, wps, seed=1, beams=360, fov=fov,
                            max_range=10.0, odom_noise=(0.01, 0.004),
                            device="cuda")
    return cfg, traj, fov


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS translational error after SE(2) alignment of the first pose."""
    def compose(a, b):
        c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                         a[..., 1] + s * b[..., 0] + c * b[..., 1],
                         a[..., 2] + b[..., 2]], -1)

    e0 = est[0].astype(np.float64)
    c, s = np.cos(e0[2]), np.sin(e0[2])
    inv = np.array([-(c * e0[0] + s * e0[1]), -(-s * e0[0] + c * e0[1]),
                    -e0[2]])
    aligned = compose(compose(gt[0], inv), est.astype(np.float64))
    return float(np.sqrt(np.mean(np.sum(
        (aligned[:, :2] - gt[:, :2]) ** 2, axis=1))))


def run_slice(cfg, traj, fov, device, max_keyframes=None, capture=None,
              max_ticks=None):
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

    slam = SingleRobotSlam(cfg, traj.ranges.shape[1], traj.gt[0],
                           traj.ranges[0], fov=fov, max_range=10.0,
                           device=device)
    cuda = slam.device.type == "cuda"
    kf_t, lat = [0], {}
    for t in range(1, min(len(traj.gt), max_ticks or len(traj.gt))):
        bucket = slam.runner.bucket(slam.state)[0]
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if slam.observe(traj.rel_odom[t - 1], traj.ranges[t]):
            if cuda:
                torch.cuda.synchronize()
            lat.setdefault(bucket, []).append(time.perf_counter() - t0)
            kf_t.append(t)
            if capture is not None and capture.armed:
                capture.settle(len(slam.infos))
            if max_keyframes and len(slam.infos) >= max_keyframes:
                break
        if int(slam.state.graph.n_vertices) >= cfg.max_vertices - 2:
            break
    return slam, np.asarray(kf_t), lat


def lattice_args(args):
    """``(ny, nx, sy, sx)`` of a K1 or K2 call."""
    return (args[6], args[7], 1, 1) if len(args) == 8 else args[6:10]


def check_kernel(kernel, args, ty, tx):
    """Kernel vs plain on one captured call over the lattice ``ty x tx``,
    then its times: ``ms`` (CUDA events over back-to-back wrapper calls),
    ``device_ms`` (CUDA graph replay: device time only, two runs) and
    ``host_us`` (the host's enqueue per wrapper call). Returns the
    record."""
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    grids, gidx, ix, iy, keep, count = args[:6]
    got = kernel(*args)
    want = plain_of(args, ty, tx)
    torch.cuda.synchronize()
    # the inputs must make the comparison able to fail: some volume with
    # kept points on a grid that is not constant, whose plain scores vary
    # along both offset axes
    live = live_volumes(grids, gidx, keep)
    spread_y, spread_x = spreads(want, live)
    assert min(spread_y, spread_x) >= MIN_SPREAD, (spread_y, spread_x)
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    ms = CT.event_ms(lambda: kernel(*args))
    plain_ms = CT.event_ms(lambda: plain_of(args, ty, tx), reps=5)
    dev_ms = [CT.graph_ms(lambda: kernel(*args)) for _ in range(2)]
    b, t, p = ix.shape
    n_off = ty.numel() * tx.numel()
    n_grids = int(torch.unique(gidx).numel())
    bound_ms, bound_by = CT.volume_bound(n_grids * grids[0].numel() * 4, b,
                                         t, p, n_off, want.numel(),
                                         int(keep.sum()))
    return {"shape": list(want.shape), "points": p,
            "grid_cells": grids.shape[-1], "grids": n_grids,
            "live_volumes": int(live.sum()),
            "spread_dy": spread_y, "spread_dx": spread_x,
            "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "device_ms": float(np.mean(dev_ms)), "device_ms_runs": dev_ms,
            "host_us": CT.host_us(lambda: kernel(*args)),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_probes(args, ty, tx, where: str) -> list:
    """Both timing probes on one captured call: each against its own
    plain version (:func:`correlate.probe_plain`; a probe is not a score
    volume), timed like the kernel. Records named ``probe_<mode>[where]``;
    ``launches`` is filled in from the main path's counts."""
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    grids, gidx, ix, iy, keep, count = args[:6]
    window = lattice_args(args)
    b, t, p = ix.shape
    n_off = ty.numel() * tx.numel()
    out = []
    for probe in (K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS):
        call = (lambda probe=probe: probe(*args[:6], *window))
        got = call()
        want = K.probe_plain(probe.mode, *args[:6], ty, tx)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # what the probe must move: no grid for no_gather, the Dy x Dx
        # cells around the one staged cell for const_cells
        grid_bytes = 0 if probe.mode == "no_gather" else n_off * 4
        bound_ms, bound_by = CT.volume_bound(grid_bytes, b, t, p, n_off,
                                             want.numel(), b * t * p)
        out.append({
            "name": f"probe_{probe.mode}[{where}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES_PROBE[probe.mode],
            "probe": True, "launches": None, "shape": list(want.shape),
            "points": p,
            "max_abs_err": float((got - want).abs().max()),
            "ms": CT.event_ms(call), "device_ms": CT.graph_ms(call),
            "host_us": CT.host_us(call),
            "plain_ms": CT.event_ms(lambda probe=probe: K.probe_plain(
                probe.mode, *args[:6], ty, tx), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    return out


def kernel_line(rec, ghz: float) -> str:
    """A record for the log, with the issue floor at ``ghz`` (T·Dy·Dx·P
    loads per volume, computed from the record's shape)."""
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    loads = math.prod(rec["shape"]) // (2 if rec.get("pair") else 1)
    floor = CT.issue_floor_ms(loads * rec["points"], ghz)
    return (f"kernel {rec['name']} {rec['shape']}: ms {rec['ms']:.4f}, "
            f"device_ms {rec['device_ms']:.5f}, host_us "
            f"{rec['host_us']:.1f}, issue floor {floor:.5f} ms at "
            f"{ghz:.3f} GHz (computed), bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']}, plain {rec['plain_ms']:.3f} ms, "
            f"max_abs_err {rec['max_abs_err']:.3g}")


def lattice(n: int, s: int, dev) -> torch.Tensor:
    return torch.arange(-n, n + 1, dtype=torch.int32, device=dev) * s


def percentiles(ms) -> str:
    v = np.asarray(ms)
    return (f"p50 {np.percentile(v, 50):.2f} ms, p99 "
            f"{np.percentile(v, 99):.2f} ms, max {v.max():.2f} ms "
            f"(n={len(v)})")


def outcomes(st) -> dict:
    """A robot's multi-robot outcomes, read on the host."""
    g = st.slam.graph
    vm = g.vmask.cpu().numpy()
    vo = st.slam.v_owner.cpu().numpy()
    em = g.emask.cpu().numpy()
    ij = g.e_ij.cpu().numpy()[em]
    lvl = g.e_level.cpu().numpy()[em]
    me = int(st.slam.my_id)
    return {"vertices": int(g.n_vertices),
            "foreign": int(((vo != me) & vm).sum()),
            "parked": int(st.parked.sum()),
            "hypotheses": int(st.peer_buf.mask.sum()),
            "inter_closures": int(((vo[ij[:, 0]] != vo[ij[:, 1]])
                                   & (lvl == 0)).sum()),
            "star_edges": int((lvl > 0).sum())}


def own_poses(st) -> np.ndarray:
    """A robot's own keyframe poses in keyframe order."""
    vm = st.slam.graph.vmask.cpu().numpy()
    vo = st.slam.v_owner.cpu().numpy()
    vr = st.slam.v_remote.cpu().numpy()
    own = np.flatnonzero(vm & (vo == int(st.slam.my_id)))
    return st.slam.graph.poses.cpu().numpy()[own[np.argsort(vr[own])]]


def cross_err(host, guest) -> np.ndarray:
    """Per foreign vertex of ``guest`` that ``host`` constrains (an edge
    touches it): the distance between the host's estimate and the
    owner's own (``tests/test_mrslam.py``'s cross-consistency check)."""
    g = host.slam.graph
    vm = g.vmask.cpu().numpy()
    vo = host.slam.v_owner.cpu().numpy()
    vr = host.slam.v_remote.cpu().numpy()
    em = g.emask.cpu().numpy()
    ij = g.e_ij.cpu().numpy()[em]
    deg = np.bincount(ij.reshape(-1), minlength=len(vm))
    gid = int(guest.slam.my_id)
    gvr = guest.slam.v_remote.cpu().numpy()
    gvo = guest.slam.v_owner.cpu().numpy()
    gvm = guest.slam.graph.vmask.cpu().numpy()
    gp = guest.slam.graph.poses.cpu().numpy()
    hp = g.poses.cpu().numpy()
    errs = []
    for slot in np.flatnonzero(vm & (vo == gid) & (deg > 0)):
        m = gvm & (gvo == gid) & (gvr == vr[slot])
        if m.any():
            errs.append(np.hypot(*(hp[slot, :2] - gp[np.argmax(m), :2])))
    return np.asarray(errs)


class Timed:
    """Wraps ``fn`` to record its time in ms. With ``sync`` the card is
    synchronized before and after the call and the host clock read (the
    end-to-end steps: a keyframe, an exchange round); otherwise, on the
    card, CUDA events are recorded around it on the current stream and
    read after the run (``ms``), so the call adds no synchronization (the
    steps inside a round)."""

    def __init__(self, fn, sync: bool, cuda: bool):
        self.fn, self.sync, self.cuda = fn, sync, cuda
        self.records = []    # ms, or a (start, end) pair of CUDA events

    def __call__(self, *a, **k):
        if self.cuda and not self.sync:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = self.fn(*a, **k)
            e1.record()
            self.records.append((e0, e1))
            return out
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        if self.sync:
            torch.cuda.synchronize()
        self.records.append((time.perf_counter() - t0) * 1e3)
        return out

    @property
    def ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
        return [r if isinstance(r, float) else r[0].elapsed_time(r[1])
                for r in self.records]


class TimedBand:
    """Wraps a banded solver entry point of ``solver.gauss_newton`` to
    record the time in ms (CUDA events on the card) of each call that
    condense makes (``chol`` off) under the band it took, read from
    ``BAND_CALLS``; ``chol`` calls (the keyframe's) pass through
    untimed."""

    def __init__(self, gn, name: str, cuda: bool):
        self.gn, self.name = gn, name
        self.fn = getattr(gn, name)
        self.timed = Timed(self.fn, False, cuda)
        self.bands = []

    def __call__(self, *a, **k):
        if k.get("chol", False):
            return self.fn(*a, **k)
        before = dict(self.gn.BAND_CALLS)
        out = self.timed(*a, **k)
        self.bands.append(next(
            b for (e, b), v in self.gn.BAND_CALLS.items()
            if e == self.name and v != before.get((e, b), 0)))
        return out

    @property
    def ms(self) -> dict:
        out = collections.defaultdict(list)
        for band, ms in zip(self.bands, self.timed.ms):
            out[band].append(ms)
        return out


def run_mr(device, max_ticks=None, capture=None, matches=None,
           before_closure=None):
    """The ``cg_mrslam`` deployment through ``MultiRobotSim`` on
    ``device``. Records, per exchange round, the tick and each robot's
    outcomes and own poses, and the keyframe ticks of each robot; with
    ``matches`` (a :class:`MatchCapture`), the inputs of accepted global
    searches and of the first star built; with ``before_closure`` (a
    dict), the robots' states going into the first round in which a robot
    accepts an inter-robot closure (host copies, taken outside the round's
    clock) and that round's tick. Returns ``(sim, times, log)``: ``times``
    maps each timed step to its times in ms."""
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim
    from cg_mrslam_tpu_torch.sim import world as W
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    cfg = deployment_config(2)
    world = W.hospital_world(40.0, 20.0, seed=0)
    sim = MultiRobotSim(cfg, world, beams=360, max_range=10.0, seed=0,
                        n_loops=2, odom_noise=(0.01, 0.004), width=40.0,
                        height=20.0, device=device)
    cuda = torch.device(device).type == "cuda"
    log = {"rounds": [], "kf_ticks": [[0] for _ in range(sim.R)]}
    keyframe, exchange = sim.keyframe, sim.exchange_round
    timers = {"keyframe": Timed(keyframe, cuda, cuda),
              "exchange_round": Timed(exchange, cuda, cuda),
              "try_match_parked": Timed(MR.try_match_parked, False, cuda),
              "build_star": Timed(MR.build_star, False, cuda)}
    bands = [TimedBand(gn, name, cuda)
             for name in ("optimize_auto", "marginal_covariance_auto")]

    def on_keyframe(r, t):
        log["kf_ticks"][r].append(t)
        return timers["keyframe"](r, t)

    def on_exchange(t, modality="sim"):
        closing = before_closure is not None and "states" not in before_closure
        if closing:
            pre = [convert.to_numpy(st) for st in sim.states]
        timers["exchange_round"](t, modality)
        if closing and any(o["inter_closures"] for o in
                           (outcomes(st) for st in sim.states)):
            before_closure.update(states=pre, tick=t,
                                  conn=sim.connectivity(t, modality))
        if capture is not None and capture.armed:
            capture.settle(len(log["rounds"]))
        if matches is not None:
            matches.settle(t)
        log["rounds"].append((t, [outcomes(st) for st in sim.states],
                              [own_poses(st) for st in sim.states]))

    sim.keyframe, sim.exchange_round = on_keyframe, on_exchange
    MR.try_match_parked = timers["try_match_parked"]
    MR.build_star = timers["build_star"]
    if matches is not None:
        MR.try_match_parked = matches.wrap_match(MR.try_match_parked)
        MR.build_star = matches.wrap_star(MR.build_star)
    for tb in bands:
        setattr(gn, tb.name, tb)
    try:
        sim.run(max_ticks=max_ticks)
    finally:
        MR.try_match_parked = timers["try_match_parked"].fn
        MR.build_star = timers["build_star"].fn
        for tb in bands:
            setattr(gn, tb.name, tb.fn)
    times = {name: t.ms for name, t in timers.items()}
    for tb in bands:
        for band, ms in tb.ms.items():
            times[f"condense {tb.name} [{band}]"] = ms
    return sim, times, log


class Cli:
    """``python -m cg_mrslam_tpu_torch argv`` started in ``chiprun_out/cli/``
    on the card; phase 9 starts its four runs together. Its standard output
    goes to ``<o>.log``, its errors to ``<o>.err``."""

    def __init__(self, *argv: str):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        self.argv = argv
        name = argv[argv.index("-o") + 1]
        self.out, self.err = CLI_DIR / f"{name}.log", CLI_DIR / f"{name}.err"
        self.t0 = time.perf_counter()
        with open(self.out, "w") as fo, open(self.err, "w") as fe:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cg_mrslam_tpu_torch", *argv],
                cwd=CLI_DIR, env=env, stdout=fo, stderr=fe)
        self.wall = None
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self):
        self.proc.wait()
        self.wall = time.perf_counter() - self.t0

    def result(self):
        """Waits for the run; fails unless it exited 0. Returns its
        standard output and wall seconds."""
        self.waiter.join()
        rc = self.proc.returncode
        assert rc == 0, (self.argv, rc, self.err.read_text()[-3000:])
        log(f"cli: {' '.join(self.argv)}: exit 0 in {self.wall:.1f} s "
            f"(the four runs of phase 9 together)")
        return self.out.read_text(), self.wall

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def keyframe_lines(stdout: str) -> list:
    """``(closures, chi2)`` of each ``keyframe`` line of an ``srslam`` run."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("keyframe "):
            f = dict(t.split("=", 1) for t in line.split()[2:])
            out.append((int(f["closures"].lstrip("+")), float(f["chi2"])))
    return out


def wall_distance(pts: np.ndarray, segs: np.ndarray) -> np.ndarray:
    """Distance from each point ``[P,2]`` to the nearest segment ``[S,4]``."""
    a, b = segs[None, :, :2], segs[None, :, 2:]
    ab = b - a
    t = np.clip(np.sum((pts[:, None] - a) * ab, -1)
                / np.maximum(np.sum(ab * ab, -1), 1e-12), 0.0, 1.0)
    near = a + t[..., None] * ab
    return np.min(np.linalg.norm(pts[:, None] - near, axis=-1), axis=1)


def read_map(base: Path):
    """A ``.pgm/.yaml`` map: the image (row 0 at the top), its origin and
    resolution."""
    head, img = (base.with_suffix(".pgm")).read_bytes().split(b"255\n", 1)
    w, h = map(int, head.split()[1:3])
    meta = dict(line.split(": ", 1) for line in
                base.with_suffix(".yaml").read_text().splitlines())
    origin = [float(v) for v in meta["origin"].strip("[]").split(",")[:2]]
    return (np.frombuffer(img, np.uint8).reshape(h, w), np.asarray(origin),
            float(meta["resolution"]))


def phase_cli(cfg, traj, fov, slam, kf_t) -> None:
    """Phase 9: the command line (see the module docstring)."""
    from cg_mrslam_tpu_torch.io import carmen
    from cg_mrslam_tpu_torch.sim import world as W

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    walls = W.hospital_world(40.0, 20.0, seed=0).segments
    # the four runs start together (independent processes on the card);
    # (c)'s log, the route's first 400 ticks, is written first
    beams = traj.ranges.shape[1]
    clf = CLI_DIR / "route.clf"
    carmen.write(str(clf), traj.odom[:400], traj.ranges[:400], fov=fov,
                 max_range=10.0, start_angle=-fov / 2,
                 angular_step=fov / beams)
    runs = [Cli("srslam", "-o", "smoke"),
            Cli("srslam", "--ticks", str(RESUME_TICK), "-o", "half"),
            Cli("srslam", "--carmen", str(clf), "-o", "carmen"),
            Cli("cg_mrslam", "--nRobots", "2", "--modality", "sim",
                "--ticks", "300", "-o", "mr")]
    try:
        cli_checks(cfg, traj, slam, kf_t, walls, runs)
    finally:
        for r in runs:
            r.stop()


def cli_checks(cfg, traj, slam, kf_t, walls, runs) -> None:
    """Phase 9's checks of its four runs, in turn."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.io import g2o
    from cg_mrslam_tpu_torch.maps import occupancy as OCC
    from cg_mrslam_tpu_torch.pipeline.slam import SingleRobotSlam

    # (a) the srslam default deployment
    out, _ = runs[0].result()
    kfl = keyframe_lines(out)
    n_kf = len(slam.infos)
    closures = sum(i.closures_added for i in slam.infos)
    assert len(kfl) == n_kf, (len(kfl), n_kf)
    assert abs(sum(c for c, _ in kfl) - closures) <= 1, (kfl, closures)
    path = str(CLI_DIR / "robot-0-smoke.g2o")
    nat = g2o.load(path, native=True)
    py = g2o.load(path, native=False)
    np.testing.assert_array_equal(nat.ids, py.ids)
    for name in ("e_ij", "emask", "e_owner", "e_level", "vmask", "fixed"):
        assert torch.equal(getattr(nat.graph, name),
                           getattr(py.graph, name)), name
    assert float((nat.graph.poses - py.graph.poses).abs().max()) <= 1e-6
    c2 = float(chi2(nat.graph))
    # 1e-3 relative, or the rounding of the printed 2 decimals
    assert abs(c2 - kfl[-1][1]) <= max(1e-3 * abs(kfl[-1][1]), 0.005), \
        (c2, kfl[-1])
    poses = nat.graph.poses.cpu().numpy()[:n_kf + 1]
    gt = traj.gt[kf_t]
    a_cli, a_p3 = ate(poses, gt), ate(slam.poses, gt)
    assert abs(a_cli - a_p3) <= 0.02, (a_cli, a_p3)
    # the file holds 6 decimals: phase 3's poses written the same way
    p3 = np.asarray([[float(f"{v:.6f}") for v in p] for p in slam.poses],
                    np.float32)
    log(f"cli: srslam: {len(kfl)} keyframes, closures "
        f"{sum(c for c, _ in kfl)} (phase 3: {closures}), loaded chi2 "
        f"{c2:.4f} (printed {kfl[-1][1]:.2f}), ATE {a_cli:.4f} m (phase 3: "
        f"{a_p3:.4f} m); largest pose difference against phase 3 "
        f"{np.abs(poses - slam.poses).max():.3g} (against phase 3 written "
        f"to 6 decimals: {np.abs(poses - p3).max():.3g})")
    img, origin, res = read_map(CLI_DIR / "robot-0-smoke-map")
    assert img.shape[0] % 128 == 0 and img.shape[1] % 128 == 0, img.shape
    rows, cols = np.nonzero(img[::-1] == 0)          # OCCUPIED, y up
    centers = origin + (np.stack([cols, rows], 1) + 0.5) * res
    dist = wall_distance(centers, walls)
    share = float((img == 0).mean())
    log(f"cli: srslam map {img.shape} (the run's poses): {len(rows)} "
        f"occupied cells, {float((dist <= 0.1).mean()):.4f} of them within "
        f"0.1 m of a wall (distance p50 {np.median(dist):.3f} m, p90 "
        f"{np.percentile(dist, 90):.3f} m), occupied share {share:.5f}")
    assert 0.001 < share < 0.2, share
    # the same scans at the ground-truth keyframe poses: the map module
    # held to tests/test_occupancy.py's bar (the run's own map is off by
    # its pose error, ATE above)
    g = nat.graph
    gt_poses = g.poses.clone()
    gt_poses[:n_kf + 1] = torch.as_tensor(gt, dtype=torch.float32,
                                          device="cuda")
    pn = gt[:, :2]
    center = OCC.map_center(gt, pad=10.0)
    cells = int(np.ceil(((pn.max(0) - pn.min(0)).max() + 20.0)
                        / cfg.map.resolution / 128.0)) * 128
    mc = cfg.map

    def integrate(poses):
        return OCC.integrate(
            poses, nat.scans, torch.as_tensor(center, device="cuda"),
            cells=cells, resolution=mc.resolution, max_range=10.0,
            usable_range=mc.usable_range, gain=mc.gain,
            square_size=mc.square_size,
            infinity_filling_range=mc.infinity_filling_range, angle=0.0,
            robot_fill=mc.robot_fill)

    tri = OCC.threshold(integrate(gt_poses)).cpu().numpy()
    rows, cols = np.nonzero(tri == OCC.OCCUPIED)     # row 0 at y min
    origin = center - mc.resolution * cells / 2.0
    near = float((wall_distance(origin + (np.stack([cols, rows], 1) + 0.5)
                                * mc.resolution, walls) <= 0.1).mean())
    share = float((tri == OCC.OCCUPIED).mean())
    log(f"cli: the same scans at the ground-truth poses: {len(rows)} "
        f"occupied cells, {near:.4f} within 0.1 m of a wall, occupied "
        f"share {share:.5f}")
    assert near >= 0.9 and 0.001 < share < 0.2, (near, share)
    metrics = CLI_DIR / "robot-0-smoke-metrics.jsonl"
    assert metrics.stat().st_size > 0

    # the outputs' own costs on this graph (455 vertices)
    vm = g.vmask.cpu().numpy()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        integrate(g.poses)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    n_samples = int(vm.sum()) * nat.scans.ranges.shape[1] * int(
        math.ceil(10.0 / (mc.resolution / math.sqrt(2.0))) + 1)
    io_ms = {}
    for name, fn in (("save", lambda: g2o.save(str(CLI_DIR / "t.g2o"), g,
                                               ids=nat.ids,
                                               scans=nat.scans)),
                     ("load native", lambda: g2o.load(path, native=True)),
                     ("load python", lambda: g2o.load(path, native=False))):
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        io_ms[name] = (time.perf_counter() - t0) / 3 * 1e3
    log(f"cli: integrate {cells}^2 cells, {n_samples} samples: "
        f"{np.median(ms):.2f} ms (median of 5), peak "
        f"{peak:.3f} GiB above the inputs; at {int(vm.sum())} vertices "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in io_ms.items()))

    # (b) resume: half the route through the command line, the rest here
    out, _ = runs[1].result()
    n_half = len(keyframe_lines(out))
    assert n_half == int((kf_t[1:] < RESUME_TICK).sum()), n_half
    half = str(CLI_DIR / "robot-0-half.g2o")
    res = SingleRobotSlam.resume(cfg, half)
    assert int(res.state.graph.n_vertices) == n_half + 1
    saved = g2o.load(half, max_vertices=cfg.max_vertices,
                     max_edges=cfg.max_edges)
    assert torch.equal(res.state.graph.poses, saved.graph.poses)
    assert int(res.state.scans.smask.sum()) == n_half + 1
    ticks = list(kf_t[:n_half + 1])
    for t in range(RESUME_TICK, len(traj.gt)):
        if res.observe(traj.rel_odom[t - 1], traj.ranges[t]):
            ticks.append(t)
        if res.runner.n_live >= cfg.max_vertices - 2:
            break
    assert all(np.isfinite(i.chi2) for i in res.infos) and res.infos
    a_res = ate(res.poses, traj.gt[ticks])
    a_odo = ate(traj.odom[ticks], traj.gt[ticks])
    log(f"cli: resume: {n_half + 1} vertices reloaded, {len(res.infos)} "
        f"keyframes after; final chi2 {res.infos[-1].chi2:.4f}, ATE "
        f"{a_res:.4f} m vs odometry ATE {a_odo:.4f} m")
    assert a_res < a_odo, (a_res, a_odo)

    # (c) a CARMEN log of the route's first 400 ticks
    out, _ = runs[2].result()
    n_c = len(keyframe_lines(out))
    assert n_c > 0 and (CLI_DIR / "robot-0-carmen.g2o").exists(), n_c
    log(f"cli: carmen: {n_c} keyframes")

    # (d) two robots in one process
    out, _ = runs[3].result()
    accepted = [int(line.rsplit("=", 1)[1]) for line in out.splitlines()
                if line.startswith("robot ") and "accepted=" in line]
    assert len(accepted) == 2 and sum(accepted) >= 1, out[-2000:]
    for r in range(2):
        for ext in (".g2o", "-map.pgm", "-map.yaml"):
            assert (CLI_DIR / f"robot-{r}-mr{ext}").exists(), (r, ext)
        ids = g2o.load(str(CLI_DIR / f"robot-{r}-mr.g2o")).ids
        ids = ids[ids >= 0]
        assert ((ids // cfg.slam.base_id) == 1 - r).any(), r
    log(f"cli: cg_mrslam: inter-robot closures accepted {accepted}")


def free_base_port(n: int, start: int = 46000) -> int:
    """A base port whose robot ports ``base + 1 .. base + n`` bind now (a
    probe bind without ``SO_REUSEADDR``)."""
    import socket

    for base in range(start, start + 2000, 10):
        socks = []
        try:
            for r in range(n):
                sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                socks.append(sk)
                sk.bind(("0.0.0.0", base + r + 1))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    raise RuntimeError("no free UDP ports")


def udp_argv(robot: int, base: int, tick_seconds: float,
             start_at: float) -> list:
    return ["cg_mrslam", "--idRobot", str(robot), "--nRobots", "2",
            "--modality", "sim", "--ticks", str(UDP_TICKS),
            "--tick-seconds", str(tick_seconds), "--start-at",
            repr(start_at), "--basePort", str(base), "--stats-json",
            f"stats-{robot}.json", "-o", "udp"]


def udp_keyframe_ticks(stdout: str) -> list:
    """The tick of every ``t=<tick> keyframe`` line of a UDP node."""
    return [int(line.split()[0][2:]) for line in stdout.splitlines()
            if line.startswith("t=") and " keyframe " in line]


def phase_udp(probes, tick_seconds: float = TICK_SECONDS) -> dict:
    """Phase 10 (see the module docstring). Returns robot 0's launch counts
    by kernel and shape."""
    import contextlib
    import io
    import threading

    from cg_mrslam_tpu_torch import cli
    from cg_mrslam_tpu_torch.core.linearize import edge_chi2
    from cg_mrslam_tpu_torch.io import g2o
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.sim import world as W

    shutil.rmtree(UDP_DIR, ignore_errors=True)
    UDP_DIR.mkdir(parents=True)
    base = free_base_port(2)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    t0 = time.perf_counter()
    # both loops start at one wall-clock time, after either process's setup
    # (robot 1's, a new process on the card, takes 6-10 s), so their
    # simulated clocks run together from the first tick
    start_at = time.time() + UDP_START_DELAY
    proc = subprocess.Popen(
        [sys.executable, "-m", "cg_mrslam_tpu_torch",
         *udp_argv(1, base, tick_seconds, start_at)], cwd=UDP_DIR, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out1, ready = [], {}

    def read():
        for line in proc.stdout:
            if line.startswith("robot 1/2 on"):
                ready[1] = time.time()
            out1.append(line)

    class Stamped(io.StringIO):
        """Robot 0's stdout, with the time its setup ended."""

        def write(self, text):
            if text.startswith("robot 0/2 on"):
                ready[0] = time.time()
            return super().write(text)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        kernels = (K.SCORE_VOLUME, K.SCORE_VOLUME_STRIDED) + probes
        for k in kernels:
            k.launches = 0
            k.launches_by_shape.clear()
        buf = Stamped()
        cwd = os.getcwd()
        os.chdir(UDP_DIR)
        try:
            with contextlib.redirect_stdout(buf):
                rc0 = cli.main(udp_argv(0, base, tick_seconds, start_at))
        finally:
            os.chdir(cwd)
        k1, k2 = K.SCORE_VOLUME.launches, K.SCORE_VOLUME_STRIDED.launches
        launches = {k: dict(k.launches_by_shape) for k in kernels[:2]}
        probe_launches = sum(k.launches for k in probes)
        rc1 = proc.wait(timeout=600)
        reader.join(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    outs = [buf.getvalue(), "".join(out1)]
    for r in range(2):
        (UDP_DIR / f"robot-{r}.log").write_text(outs[r])
    assert rc0 == 0 and rc1 == 0, (rc0, rc1, outs[1][-3000:])
    # both set up before the common start
    assert max(ready.values()) < start_at, (ready, start_at)
    stats = [json.loads((UDP_DIR / f"stats-{r}.json").read_text())
             for r in range(2)]
    cfg = deployment_config(2)
    world = W.hospital_world(40.0, 20.0, seed=0)
    fov = 2 * np.pi * 0.75
    graphs, own, gts = [], [], []
    for r in range(2):
        s = stats[r]
        tick_line = next(line for line in outs[r].splitlines()
                         if " ticks in " in line)
        log(f"udp: robot {r}: {s['keyframes']} keyframes, {tick_line}; "
            f"wall {s['wall_s']} s; sent {s['sent']} messages "
            f"{s['bytes_sent']} B, received {s['received']} messages "
            f"{s['bytes_received']} B; dropped: closure list "
            f"{s['closure_list_dropped']}, star {s['star_dropped']}, "
            f"capacity {s['keyframes_capacity_stopped']}; decode errors "
            f"{s['decode_errors']}; vertices {s['n_vertices']} (foreign "
            f"{s['foreign_vertices']}), inter-robot accepted "
            f"{s['inter_robot_accepted']}, star edges in "
            f"{s['condensed_star_edges_in']}")
        assert s["transport"] == "native" and s["backend"] == "cuda", s
        assert s["received"] > 0 and s["decode_errors"] == 0, s
        assert s["foreign_vertices"] > 0, s
        lg = g2o.load(str(UDP_DIR / f"robot-{r}-udp.g2o"), native=True)
        g = lg.graph
        c2 = edge_chi2(g)[g.emask]
        assert bool(torch.isfinite(c2).all()), r
        graphs.append(lg)
        ids = lg.ids
        mine = np.flatnonzero((ids >= 0) & (ids // cfg.slam.base_id == r))
        mine = mine[np.argsort(ids[mine])]
        own.append(g.poses.cpu().numpy()[mine])
        ticks = [0] + udp_keyframe_ticks(outs[r])
        assert len(ticks) == len(mine) == s["keyframes"] + 1, \
            (r, len(ticks), len(mine))
        tr = W.simulate_robot(world, W.corridor_waypoints(40.0, 20.0, r, 2),
                              seed=7 * r, beams=360, fov=fov,
                              max_range=10.0, odom_noise=(0.01, 0.004),
                              device="cuda")
        gts.append((tr, ticks))
    assert sum(s["inter_robot_accepted"] for s in stats) >= 1, stats
    assert sum(s["condensed_star_edges_in"] for s in stats) >= 1, stats
    for r in range(2):
        lg, peer = graphs[r], graphs[1 - r]
        g = lg.graph
        em = g.emask.cpu().numpy()
        deg = np.bincount(g.e_ij.cpu().numpy()[em].reshape(-1),
                          minlength=len(lg.ids))
        pos = dict(zip(peer.ids.tolist(), peer.graph.poses.cpu().numpy()))
        hp = g.poses.cpu().numpy()
        errs = np.asarray([
            np.hypot(*(hp[k, :2] - pos[i][:2])) for k, i in
            enumerate(lg.ids.tolist()) if i >= 0 and deg[k] > 0
            and i // cfg.slam.base_id == 1 - r and i in pos])
        tr, ticks = gts[r]
        a_slam = ate(own[r], tr.gt[ticks])
        a_odom = ate(tr.odom[ticks], tr.gt[ticks])
        log(f"udp: robot {r}: ATE {a_slam:.4f} m vs odometry ATE "
            f"{a_odom:.4f} m; cross-robot agreement on {len(errs)} "
            f"vertices: median "
            f"{np.median(errs) if len(errs) else float('nan'):.4f} m, max "
            f"{errs.max() if len(errs) else float('nan'):.4f} m, "
            f"{int((errs > 1.0).sum())} over 1 m; edge chi2 "
            f"sum {float(edge_chi2(g)[g.emask].sum()):.4f}")
        assert a_slam < a_odom, (r, a_slam, a_odom)
        assert len(errs) > 0 and np.median(errs) < MAX_AGREEMENT_M, (r, errs)
    n_kf = stats[0]["keyframes"]
    rounds = int(outs[0].split(" ticks in ")[0].rsplit("\n", 1)[-1]) + 60
    pairs = launches[K.SCORE_VOLUME_STRIDED]
    log(f"udp: robot 0's process: K1 launches {k1} ({n_kf} keyframes), K2 "
        f"launches {k2} ({n_kf} keyframes + {rounds} comm rounds), probes "
        f"{probe_launches}; setup done {start_at - ready[1]:.2f} s "
        f"(robot 1) and {start_at - ready[0]:.2f} s (robot 0) before the "
        f"common start; phase wall {wall:.1f} s at {tick_seconds} s a tick")
    assert k1 == 3 * n_kf, (k1, n_kf)
    assert k2 > 0 and k2 == 4 * (n_kf + rounds), (k2, n_kf, rounds)
    assert all(k[1] == 2 and len(k) == 7 for k in pairs), pairs
    assert probe_launches == 0, "a probe ran on the path"
    return launches


class MatchCapture:
    """Keeps, from a multi-robot run, the input state and the buffered
    hypothesis of every global search that accepted a match
    (``try_match_parked`` with ``ok`` true), and the input of the first
    ``build_star`` call with a requested boundary. The calls are held for
    one exchange round and sorted out after it, outside its clock (a host
    read of the buffered hypotheses)."""

    def __init__(self):
        self.matches = []    # (tick, state in, hypothesis)
        self.star = None     # (tick, state, peer)
        self._calls, self._stars = [], []

    def wrap_match(self, fn):
        def call(st, cfg):
            out = fn(st, cfg)
            self._calls.append((st, out))
            return out
        return call

    def wrap_star(self, fn):
        def call(st, peer, *a, **k):
            if self.star is None:
                self._stars.append((st, peer))
            return fn(st, peer, *a, **k)
        return call

    def settle(self, t: int) -> None:
        for st, out in self._calls:
            hyp = new_hypothesis(st, out)
            if hyp is not None:
                self.matches.append((t, st, hyp))
        for st, peer in self._stars:
            if self.star is None and bool(st.in_closures[peer].any()):
                self.star = (t, st, peer)
        self._calls.clear()
        self._stars.clear()


def first_star(matches):
    """Phase 6's first star request ``(tick, state, peer, requested)``,
    cut to the newest ``STAR_CAP`` boundary vertices (phase 11 (f) and
    phase 13 (e))."""
    from cg_mrslam_tpu_torch.core import graph as G

    t, st, peer = matches.star
    sel = st.in_closures[peer]
    n_req = int(sel.sum())
    if n_req > STAR_CAP:
        score = torch.where(sel, st.slam.v_remote,
                            torch.full_like(st.slam.v_remote, -1))
        _, keep = G.first_k(score, STAR_CAP)
        row = torch.zeros_like(sel)
        row[keep] = True
        in_c = st.in_closures.clone()
        in_c[peer] = row
        st = dataclasses.replace(st, in_closures=in_c)
    return t, st, peer, n_req


def new_hypothesis(st, out):
    """The hypothesis a ``try_match_parked`` call buffered, read on the
    host: ``(my vertex, matched vertex, z)``, or None when it matched
    nothing (a rejected match writes no slot, so the buffers are equal)."""
    a, b = st.peer_buf, out.peer_buf
    changed = ((a.mask != b.mask) | (a.age != b.age) | (a.v_old != b.v_old)
               | (a.v_new != b.v_new) | (a.z != b.z).any(-1))
    at = torch.nonzero(changed)
    if at.numel() == 0:
        return None
    assert at.shape[0] == 1, at
    p, w = at[0].tolist()
    return int(b.v_old[p, w]), int(b.v_new[p, w]), b.z[p, w].cpu().numpy()


def wrap_angle(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, np.float64).copy()
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    return d


def timed_call(fn, cuda: bool):
    """``fn()`` and its wall seconds (the card synchronized around it)."""
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def keyframe_map(state, slots):
    """World points and mask of the scans of ``slots`` (``srslam`` state)."""
    from cg_mrslam_tpu_torch.core import scan as S
    from cg_mrslam_tpu_torch.utils import se2

    s = torch.as_tensor(slots, device=state.graph.poses.device).long()
    pts = se2.apply(state.graph.poses[s], S.scan_points(state.scans, s))
    valid = S.beam_valid(state.scans, s) & state.scans.smask[s][:, None]
    return pts.reshape(-1, 2), valid.reshape(-1)


def keyframe_scan(state, k: int):
    from cg_mrslam_tpu_torch.core import scan as S

    kk = torch.tensor([k], device=state.graph.poses.device)
    return (S.scan_points(state.scans, kk)[0],
            S.beam_valid(state.scans, kk)[0] & state.scans.smask[k])


def on_cpu(args):
    return tuple(a.cpu() if torch.is_tensor(a) else a for a in args)


def phase_matcher(slam, cfg, matches, sim, mlog, probes, ghz, udp):
    """Phase 11 (see the module docstring). Returns the kernel and probe
    records of the new shapes."""
    import cg_mrslam_tpu_torch.matcher.search as search
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.matcher import matching as M
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.solver import initial_guess as IG
    from cg_mrslam_tpu_torch.utils import se2

    cpu = torch.device("cpu")
    torch.set_num_threads(8)
    records, probe_records = [], []
    state = slam.state
    card = state.graph.poses.device
    on_card = card.type == "cuda"
    n_kf = len(slam.infos)
    lc, win = cfg.lc_matcher, cfg.windows

    # (a), (b): keyframe k against the LC grid of its ±MAP_WINDOW
    # neighbours, from a guess moved by a planted offset
    k = n_kf // 2
    nb = [j for j in range(k - MAP_WINDOW, k + MAP_WINDOW + 1) if j != k]
    ref, ref_valid = keyframe_map(state, nb)
    cur, cur_valid = keyframe_scan(state, k)
    pose_k = state.graph.poses[k].cpu().numpy()
    for mode, fn, planted, strides in (
            ("global", M.global_match, PLANTED, GLOBAL_LEVELS),
            ("lc_hierarchical", M.loop_closure_match_hierarchical,
             PLANTED_LC, LC_LEVELS)):
        guess = torch.as_tensor(pose_k + np.asarray(planted, np.float32),
                                device=card)
        args = (ref, ref_valid, cur, cur_valid, guess)
        capture = Capture(K.SCORE_VOLUME_STRIDED,
                          lambda a, strides=strides: strides[a[8]],
                          set(strides.values()))
        search.SCORE_VOLUME_STRIDED = capture
        K.SCORE_VOLUME_STRIDED.launches = 0
        K.SCORE_VOLUME_STRIDED.launches_by_shape.clear()
        try:
            got, sec = timed_call(lambda: fn(*args, cfg=lc, windows=win),
                                  on_card)
        finally:
            search.SCORE_VOLUME_STRIDED = K.SCORE_VOLUME_STRIDED
        launches = K.SCORE_VOLUME_STRIDED.launches
        by_shape = dict(K.SCORE_VOLUME_STRIDED.launches_by_shape)
        capture.settle(k)
        want, sec_cpu = timed_call(lambda: fn(*on_cpu(args), cfg=lc,
                                              windows=win), False)
        d_card = wrap_angle(got.pose.cpu().numpy() - pose_k)
        d_cpu = wrap_angle(want.pose.numpy() - pose_k)
        log(f"matcher: {mode} of keyframe {k} on its {len(nb)} neighbours' "
            f"grid from a guess {planted} off: card {sec * 1e3:.2f} ms "
            f"(host clock, synchronized), CPU {sec_cpu * 1e3:.1f} ms; "
            f"pose error card {np.round(d_card, 5).tolist()}, CPU "
            f"{np.round(d_cpu, 5).tolist()}; score card "
            f"{float(got.score):.6f}, CPU {float(want.score):.6f}; K2 "
            f"launches {launches} {by_shape}")
        step = np.asarray([lc.resolution, lc.resolution, win.lc_th_res
                           if mode == "lc_hierarchical"
                           else win.global_th_res]) + 1e-4
        assert np.all(np.abs(d_card) <= step), (mode, d_card)
        assert np.all(np.abs(d_cpu) <= step), (mode, d_cpu)
        assert np.abs(wrap_angle(got.pose.cpu().numpy()
                                 - want.pose.numpy())).max() <= 1e-4
        assert abs(float(got.score) - float(want.score)) <= 1e-5
        assert launches == len(strides), (mode, launches)
        # every level one launch of the single-grid entry (no pair: keys
        # (B, T, Dy, Dx, sy, sx))
        assert all(len(key) == 6 for key in by_shape), by_shape
        assert sorted(capture.calls) == sorted(strides.values()), \
            sorted(capture.calls)
        for stride, name in strides.items():
            cargs = capture.calls[name]
            dev = cargs[0].device
            ty = lattice(cargs[6], stride, dev)
            tx = lattice(cargs[7], stride, dev)
            rec = check_kernel(K.SCORE_VOLUME_STRIDED, cargs, ty, tx)
            key = tuple(rec["shape"]) + (stride, stride)
            rec = {"name": f"score_volume_strided[{mode}_{name}]",
                   "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES_K2, "pair": False,
                   "launches": by_shape[key], "launches_main_path": 0,
                   "launches_udp_robot0": udp[K.SCORE_VOLUME_STRIDED].get(
                       key, 0),
                   "stride": stride, **rec}
            assert by_shape[key] == 1, (mode, name, by_shape)
            records.append(rec)
            log(kernel_line(rec, ghz) + f" ({mode}, {rec['live_volumes']} "
                f"live volumes, spread {rec['spread_dy']:.4g}/"
                f"{rec['spread_dx']:.4g})")
            for pr in check_probes(cargs, ty, tx, f"{mode}_{name}"):
                pr["launches"] = 0
                probe_records.append(pr)
                log(kernel_line(pr, ghz))

    # (c) the region search of a keyframe that closed a loop: regions at
    # its own pose and at its loop partners', one shared grid of the
    # partners' neighbourhoods (one K1 launch)
    g = state.graph
    ij = np.sort(g.e_ij.cpu().numpy()[g.emask.cpu().numpy()], axis=1)
    loops = ij[ij[:, 1] - ij[:, 0] > 1]          # (old, new) loop edges
    c = int(loops[:, 1].min())
    partners = sorted({int(a) for a, b in loops if b == c})
    regions = np.zeros((LC_REGIONS, 3), np.float32)
    rvalid = np.zeros(LC_REGIONS, bool)
    poses = g.poses.cpu().numpy()
    for i, v in enumerate([c] + partners[:LC_REGIONS - 1]):
        regions[i], rvalid[i] = poses[v], True
    near = sorted({j for p in partners for j in range(p - 5, p + 6)
                   if 0 <= j < n_kf + 1 and abs(j - c) > 1})
    ref, ref_valid = keyframe_map(state, near)
    cur, cur_valid = keyframe_scan(state, c)
    args = (ref, ref_valid, cur, cur_valid,
            torch.as_tensor(regions, device=card),
            torch.as_tensor(rvalid, device=card))
    capture = Capture(K.SCORE_VOLUME, lambda a: "lc_shared", {"lc_shared"})
    search.SCORE_VOLUME = capture
    K.SCORE_VOLUME.launches = 0
    K.SCORE_VOLUME.launches_by_shape.clear()
    try:
        got, sec = timed_call(lambda: M.loop_closure_match(
            *args, cfg=lc, windows=win), on_card)
    finally:
        search.SCORE_VOLUME = K.SCORE_VOLUME
    k1 = K.SCORE_VOLUME.launches
    k1_by = dict(K.SCORE_VOLUME.launches_by_shape)
    capture.settle(c)
    want, sec_cpu = timed_call(lambda: M.loop_closure_match(
        *on_cpu(args), cfg=lc, windows=win), False)
    log(f"matcher: loop_closure_match of keyframe {c} (loop partners "
        f"{partners}), {int(rvalid.sum())} regions + twins on one grid of "
        f"{len(near)} scans: card {sec * 1e3:.2f} ms, CPU "
        f"{sec_cpu * 1e3:.1f} ms; scores card "
        f"{np.round(got.scores.cpu().numpy(), 6).tolist()}, CPU "
        f"{np.round(want.scores.numpy(), 6).tolist()}; K1 launches {k1} "
        f"{k1_by}")
    assert k1 == 1 and rvalid.sum() >= 2, (k1, partners)
    assert np.abs(wrap_angle(got.poses.cpu().numpy()
                             - want.poses.numpy())).max() <= 1e-4
    assert float((got.scores.cpu() - want.scores).abs().max()) <= 1e-5
    cargs = capture.calls["lc_shared"]
    dev = cargs[0].device
    ty, tx = lattice(cargs[6], 1, dev), lattice(cargs[7], 1, dev)
    rec = check_kernel(K.SCORE_VOLUME, cargs, ty, tx)
    key = tuple(rec["shape"])
    rec = {"name": "score_volume[lc_shared_grid]", "route": "cuda",
           "source": SOURCE, "replaces": REPLACES, "launches": k1_by[key],
           "launches_main_path": 0,
           "launches_udp_robot0": udp[K.SCORE_VOLUME].get(key, 0), **rec}
    records.append(rec)
    log(kernel_line(rec, ghz) + f" ({rec['live_volumes']} live volumes)")
    for pr in check_probes(cargs, ty, tx, "lc_shared_grid"):
        pr["launches"] = 0
        probe_records.append(pr)
        log(kernel_line(pr, ghz))

    # (e) the visibility gate on phase 6's accepted global searches: all
    # of them on the card, the first N_MATCHES also on the CPU
    assert len(matches.matches) >= N_MATCHES, len(matches.matches)
    mcfg = sim.cfg
    gated = dataclasses.replace(mcfg, mr=dataclasses.replace(
        mcfg.mr, detect_robot_in_range=True))
    kf_ticks = mlog["kf_ticks"]
    passed, wrong, t_gate = [], [], []
    for i, (t, st, (v_ref, v_new, z)) in enumerate(matches.matches):
        on, sec = timed_call(lambda: MR.try_match_parked(st, gated), on_card)
        t_gate.append(sec * 1e3)
        hyp = new_hypothesis(st, on)
        if i < N_MATCHES:
            st_cpu = convert.mr_state_from_numpy(convert.to_numpy(st), cpu)
            hyp_cpu = new_hypothesis(st_cpu,
                                     MR.try_match_parked(st_cpu, gated))
            ungated = new_hypothesis(st_cpu,
                                     MR.try_match_parked(st_cpu, mcfg))
            assert (hyp is None) == (hyp_cpu is None), t
            assert ungated is not None and ungated[:2] == (v_ref, v_new), t
            assert np.abs(wrap_angle(ungated[2] - z)).max() <= 1e-4, t
            if hyp is not None:
                assert hyp[:2] == (v_ref, v_new) == hyp_cpu[:2], t
                assert np.abs(wrap_angle(hyp[2] - hyp_cpu[2])).max() <= 1e-4
        r = int(st.slam.my_id)
        vr = st.slam.v_remote.cpu().numpy()
        peer = int(st.slam.v_owner[v_new])
        gt_ref = sim.trajs[r].gt[kf_ticks[r][vr[v_ref]]]
        gt_new = sim.trajs[peer].gt[kf_ticks[peer][vr[v_new]]]
        z_gt = se2.relative(torch.as_tensor(gt_ref, dtype=torch.float64),
                            torch.as_tensor(gt_new, dtype=torch.float64))
        passed.append(hyp is not None)
        wrong.append(float(np.hypot(*(z[:2] - z_gt[:2].numpy()))) > 1.0)
    passed, wrong = np.asarray(passed), np.asarray(wrong)
    first = slice(0, N_MATCHES)
    log(f"matcher: visibility gate on phase 6's accepted global searches: "
        f"the first {N_MATCHES} (ticks {matches.matches[0][0]}.."
        f"{matches.matches[N_MATCHES - 1][0]}; card and CPU decide alike): "
        f"the gate passes {int(passed[first].sum())}, {int(wrong[first].sum())}"
        f" are wrong (> 1 m from the ground-truth relative pose), the gate "
        f"passes {int((passed & wrong)[first].sum())} of those; all "
        f"{len(passed)} (ticks up to {matches.matches[-1][0]}, on the card): "
        f"the gate passes {int(passed.sum())}, {int(wrong.sum())} are wrong, "
        f"the gate passes {int((passed & wrong).sum())} of those; gated "
        f"try_match_parked {percentiles(t_gate)} (host clock, "
        f"synchronized)")

    # (f) the optimal gauge at the first star of phase 6
    t, st, peer, n_req = first_star(matches)
    n_k = int(st.in_closures[peer].sum())
    st_cpu = convert.mr_state_from_numpy(convert.to_numpy(st), cpu)
    gn.BAND_CALLS.clear()
    star, sec = timed_call(lambda: MR.build_star(st, peer,
                                                 gauge_mode="optimal"),
                           on_card)
    bands = dict(gn.BAND_CALLS)
    star_cpu, sec_cpu = timed_call(lambda: MR.build_star(
        st_cpu, peer, gauge_mode="optimal"), False)
    centroid = MR.build_star(st, peer)
    log(f"matcher: optimal gauge at the first star (tick {t}, robot "
        f"{int(st.slam.my_id)} to {peer}): K = {n_k} candidates"
        + (f" (the first {STAR_CAP} of {n_req} requested, newest first)"
           if n_req > STAR_CAP else "")
        + f"; gauge {int(star.gauge)} on the card, {int(star_cpu.gauge)} "
        f"on the CPU (centroid gauge {int(centroid.gauge)}); build_star "
        f"card {sec:.3f} s (host clock, synchronized; solver bands "
        f"{bands}), CPU {sec_cpu:.2f} s")
    assert int(star.gauge) == int(star_cpu.gauge)

    # (g) LM from the spanning-tree guess on phase 3's final graph with its
    # free poses perturbed
    rng = np.random.default_rng(0)
    free = (g.vmask & ~g.fixed).cpu().numpy()
    noise = rng.normal(0.0, 1.0, g.poses.shape) * np.asarray(
        PERTURB)[[0, 0, 1]] * free[:, None]
    p0 = g.poses + torch.as_tensor(noise, dtype=torch.float32, device=card)
    p0 = torch.cat([p0[:, :2], se2.normalize_angle(p0[:, 2:])], 1)
    g0 = dataclasses.replace(g, poses=p0)
    sweeps = int(g.n_vertices)
    out = {}
    for name, gg in (("card", g0), ("cpu", convert.from_numpy(
            type(g0), convert.to_numpy(g0), cpu))):
        sync = on_card and name == "card"
        (dist, poses), t_tree = timed_call(
            lambda gg=gg: IG.spanning_tree(gg, sweeps=sweeps), sync)
        tree = dataclasses.replace(gg, poses=poses)
        lm, t_lm = timed_call(lambda: gn.optimize_lm(tree, LM_ITERS), sync)
        chi = [float(chi2(x)) for x in (gg, tree, lm)]
        log(f"matcher: {name}: chi2 perturbed {chi[0]:.4f}, after the "
            f"spanning tree ({sweeps} sweeps, {t_tree:.3f} s) {chi[1]:.4f}, "
            f"after optimize_lm ({LM_ITERS} iterations, {t_lm:.3f} s) "
            f"{chi[2]:.4f}")
        assert chi[2] < chi[1], (name, chi)
        out[name] = dist.cpu(), poses.cpu().numpy(), lm.poses.cpu().numpy()
    (d_a, tree_a, lm_a), (d_b, tree_b, lm_b) = out["card"], out["cpu"]
    d_tree = np.abs(wrap_angle(tree_a - tree_b)).max()
    d_lm = np.abs(wrap_angle(lm_a - lm_b)).max()
    log(f"matcher: card against CPU: hop distances equal "
        f"{bool(torch.equal(d_a, d_b))}, tree poses {d_tree:.3g}, LM poses "
        f"{d_lm:.3g}")
    assert torch.equal(d_a, d_b) and d_tree <= 1e-4 and d_lm <= 1e-3, \
        (d_tree, d_lm)
    return records, probe_records


# ------------------------------------------------------------------ phase 12


def flat_cmp(a: dict, b: dict, atol=1e-3):
    """``tests/test_fleet.py:_flat_cmp``'s bar on two ``convert.to_numpy``
    dicts: integer and bool leaves equal, float leaves within ``atol`` +
    1e-5 of the leaf's largest magnitude. Returns the largest float
    difference."""
    assert a.keys() == b.keys(), sorted(set(a) ^ set(b))
    worst = 0.0
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if y.dtype == bool or np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x, y, err_msg=k)
            continue
        scale = float(np.abs(y).max()) if y.size else 0.0
        np.testing.assert_allclose(x, y, rtol=0, atol=atol + 1e-5 * scale,
                                   err_msg=k)
        if y.size:
            worst = max(worst, float(np.abs(x.astype(np.float64) - y).max()))
    return worst


def phase_viz(slam) -> None:
    """(a) The four exports of ``maps/viz.py`` on phase 3's final state, on
    the card and on a CPU copy."""
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.maps import viz

    PHASE12_DIR.mkdir(parents=True, exist_ok=True)
    st = slam.state
    cpu = convert.state_from_numpy(convert.state_to_numpy(st), "cpu")
    ms = {}
    out = {}
    for name, dev_state, device in (("card", st, "cuda"), ("cpu", cpu, "cpu")):
        cuda = device == "cuda"
        tr, s1 = timed_call(lambda: viz.trajectory(dev_state), cuda)
        pts, s2 = timed_call(lambda: viz.laser_map_points(dev_state), cuda)
        corr, s3 = timed_call(lambda: viz.map_to_odom(
            tr[-1], slam.infos[-1].pose + np.float32([0.3, -0.2, 0.1]),
            device=device), cuda)
        path = PHASE12_DIR / f"map-{name}.pgm"
        _, s4 = timed_call(lambda: viz.render_png(str(path), dev_state),
                           cuda)
        out[name] = (tr, pts, corr, path.read_bytes())
        ms[name] = [1e3 * x for x in (s1, s2, s3, s4)]
    tr, pts, corr, pgm = out["card"]
    tr_c, pts_c, corr_c, pgm_c = out["cpu"]
    np.testing.assert_array_equal(tr, tr_c)
    assert len(tr) == len(slam.infos) + 1, (len(tr), len(slam.infos))
    assert pts.shape == pts_c.shape and len(pts) > 1000, pts.shape
    np.testing.assert_allclose(pts, pts_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(corr, corr_c, rtol=0, atol=1e-5)
    # the size its bounds give (laser map at stride 1 and every vertex,
    # 2 m of padding, 0.05 m a pixel)
    allp = np.concatenate([viz.trajectory(cpu, own_only=False)[:, :2],
                           viz.laser_map_points(cpu, stride=1)])
    lo, hi = allp.min(0) - 2.0, allp.max(0) + 2.0
    w, h = (int(np.ceil((hi[k] - lo[k]) / 0.05)) for k in (0, 1))
    head = b"P5\n%d %d\n255\n" % (w, h)
    assert pgm.startswith(head) and len(pgm) == len(head) + w * h, pgm[:20]
    diff = float(np.mean(np.frombuffer(pgm[len(head):], np.uint8)
                         != np.frombuffer(pgm_c[len(head):], np.uint8)))
    assert diff <= 1e-3, diff
    names = ("trajectory", "laser_map_points", "map_to_odom", "render_png")
    log("viz: card / CPU ms: " + ", ".join(
        f"{n} {a:.2f} / {b:.2f}" for n, a, b in zip(names, ms["card"],
                                                   ms["cpu"]))
        + f"; {len(tr)} poses, {len(pts)} map points (stride 10), PGM "
        f"{w} x {h}, pixels differing card/CPU {diff:.2e}")


class Recorded:
    """A ``SensorSource`` around a ``UdpJsonSource``: keeps every parsed
    datagram, and releases ``window`` once for every datagram it reads, so
    that the sender never has more than the window in flight (the socket's
    buffer never overflows); ``wait_s`` sums the seconds ``read`` spent
    producing its pairs (receiving and parsing), ``last`` is the host clock
    at the last datagram. After ``open`` the socket waits ``read_timeout``
    seconds for a datagram: the stream ends at the first wait that long."""

    def __init__(self, src, window, read_timeout):
        self.src, self.window = src, window
        self.read_timeout = read_timeout
        self.packets = []
        self.wait_s = 0.0
        self.last = None
        read = src._next_packet

        def counted():
            pkt = read()
            if pkt is not None:
                self.last = time.perf_counter()
                self.packets.append(pkt)
                window.release()
            return pkt

        src._next_packet = counted

    def open(self):
        out = self.src.open()
        self.src._sock.settimeout(self.read_timeout)
        return out

    def read(self):
        it = self.src.read()
        while True:
            t0 = time.perf_counter()
            pair = next(it, None)
            if pair is None:
                return
            self.wait_s += time.perf_counter() - t0
            yield pair


def phase_stream(cfg, traj, fov, infos, kf_t) -> None:
    """(b) The first ``STREAM_TICKS`` ticks of phase 3's route over
    localhost to a ``UdpJsonSource`` (one geometry header, absolute
    odometry dead-reckoned in float64, the route's scans);
    ``run_slam_on_source`` on the card."""
    import json
    import socket
    import threading

    from cg_mrslam_tpu_torch.io import stream as ST

    beams = traj.ranges.shape[1]
    odom = [np.asarray(traj.gt[0], np.float64)]
    for rel in traj.rel_odom[:STREAM_TICKS - 1]:
        a = odom[-1]
        c, s = np.cos(a[2]), np.sin(a[2])
        odom.append(np.array([a[0] + c * rel[0] - s * rel[1],
                              a[1] + s * rel[0] + c * rel[1],
                              (a[2] + rel[2] + np.pi) % (2 * np.pi) - np.pi]))
    sent = [{"geometry": {"beams": beams, "first_beam_angle": -fov / 2,
                          "angular_step": fov / beams, "max_range": 10.0}}]
    sent += [{"odom": o.tolist(), "ranges": traj.ranges[t].tolist()}
             for t, o in enumerate(odom)]
    port = free_base_port(1, start=47000) + 1
    window = threading.Semaphore(16)
    src = Recorded(ST.UdpJsonSource(port, host="127.0.0.1", timeout=30.0),
                   window, read_timeout=3.0)

    def sender():
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
            for pkt in sent:
                window.acquire()
                tx.sendto(json.dumps(pkt).encode(), ("127.0.0.1", port))

    th = threading.Thread(target=sender, daemon=True)
    th.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        slam = ST.run_slam_on_source(src, cfg=cfg, device="cuda")
    finally:
        src.src.close()
    wall = src.last - t0       # to the last datagram: not the final wait
    th.join(30.0)
    assert not th.is_alive()
    assert src.packets == sent, (len(src.packets), len(sent))
    n = int(np.sum((kf_t > 0) & (kf_t < STREAM_TICKS)))
    assert len(slam.infos) == n, (len(slam.infos), n)
    d = wrap_angle(np.stack([i.pose for i in slam.infos])
                   - np.stack([i.pose for i in infos[:n]]))
    assert np.abs(d).max() <= 1e-3, np.abs(d).max()
    kf_ms = 1e3 * np.asarray(slam.metrics.values("keyframe_latency"))
    log(f"stream: {len(sent)} datagrams received as sent, {n} keyframes "
        f"(phase 3: {n} over ticks 1..{STREAM_TICKS - 1}), poses within "
        f"{np.abs(d).max():.3g} of phase 3's; {wall:.2f} s, "
        f"{1e3 * wall / n:.1f} ms a keyframe (ingestion included): the "
        f"keyframe steps {percentiles(kf_ms)}, total {kf_ms.sum() / 1e3:.2f}"
        f" s; reading the datagrams {src.wait_s:.2f} s")


def round_ms(times, mlog, n_rounds: int) -> list:
    """Phase 6's time of each of its first ``n_rounds`` rounds: the
    keyframes of the round's tick and the exchange (host clock,
    synchronized), in ms."""
    kf = iter(times["keyframe"])
    out = []
    for k in range(n_rounds):
        t = mlog["rounds"][k][0]
        steps = sum(t in ticks for ticks in mlog["kf_ticks"])
        out.append(sum(next(kf) for _ in range(steps))
                   + times["exchange_round"][k])
    return out


def phase_fleet(sim, mlog, times, first: int, records) -> None:
    """(c) ``FleetSim`` at phase 6's full width over phase 6's scans, up to
    ``FLEET_EXTRA_TICKS`` past its first inter-robot closure."""
    import cg_mrslam_tpu_torch.parallel.fleet_sim as FS
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.parallel import fleet as F
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    cfg = deployment_config(2)
    t_first = mlog["rounds"][first][0]
    fs = FS.FleetSim(cfg, None, beams=360, max_range=10.0, device="cuda",
                     trajectories=sim.trajs)
    calls, ticks = [], []
    real = FS.fleet_keyframe_round

    def recording(states, do, ests, ranges, conn, cfg_, nb, eb):
        out = real(states, do, ests, ranges, conn, cfg_, nb, eb)
        calls.append((nb, eb, out[0]))
        return out

    conn_of = fs._connectivity

    def at_tick(t):
        ticks.append(t)
        return conn_of(t)

    fs._connectivity = at_tick
    FS.fleet_keyframe_round = recording
    for k in (K.SCORE_VOLUME, K.SCORE_VOLUME_STRIDED, K.PROBE_NO_GATHER,
              K.PROBE_CONST_CELLS):
        k.launches = 0
        k.launches_by_shape.clear()
    gn.BAND_CALLS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fs.run(max_ticks=t_first + FLEET_EXTRA_TICKS + 1)
    finally:
        FS.fleet_keyframe_round = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = K.SCORE_VOLUME.launches, K.SCORE_VOLUME_STRIDED.launches
    k1_by = dict(K.SCORE_VOLUME.launches_by_shape)
    k2_by = dict(K.SCORE_VOLUME_STRIDED.launches_by_shape)
    probes = K.PROBE_NO_GATHER.launches + K.PROBE_CONST_CELLS.launches
    bands = dict(gn.BAND_CALLS)
    n_rounds = len(calls)
    n_kf = sum(len(g) - 1 for g in fs.kf_gt)
    assert len(ticks) == n_rounds > first + 1, (len(ticks), first)
    # up to and including the first inter-robot closure every round's
    # outcomes are phase 6's (after it, the bucket's condense band may
    # differ from phase 6's at capacity, and a near tie may flip)
    for k, ((nb, eb, states), t) in enumerate(zip(calls[:first + 1],
                                                  ticks)):
        assert t == mlog["rounds"][k][0], (k, t, mlog["rounds"][k][0])
        got = [outcomes(st) for st in F.unstack_states(states, 2)]
        assert got == mlog["rounds"][k][1], (k, got, mlog["rounds"][k][1])
    final = F.unstack_states(fs.states, 2)
    t_last = ticks[-1]
    k6 = max(k for k, r in enumerate(mlog["rounds"]) if r[0] <= t_last)
    ates = []
    for r, st in enumerate(final):
        a_f = ate(own_poses(st), np.asarray(fs.kf_gt[r]))
        kt = [t for t in mlog["kf_ticks"][r] if t <= mlog["rounds"][k6][0]]
        a_6 = ate(mlog["rounds"][k6][2][r], sim.trajs[r].gt[kt])
        assert abs(a_f - a_6) < 0.05, (r, a_f, a_6)
        ates.append((a_f, a_6))
    outs = [outcomes(st) for st in final]
    assert sum(o["star_edges"] for o in outs) >= 1, outs
    assert k1 == 3 * n_kf, (k1, n_kf)
    assert k2 == 4 * fs.R * n_rounds, (k2, n_rounds)
    assert all(k[1] == 2 and len(k) == 7 for k in k2_by), k2_by
    assert probes == 0, "a probe ran on the fleet path"
    for rec in records:      # K2's records carry their stride
        strided = rec.get("stride") is not None
        key = tuple(rec["shape"]) + ((rec["stride"],) * 2 if strided else ())
        rec["launches_fleet_sim"] = (k2_by if strided else k1_by).get(key, 0)
    fleet_ms = [1e3 * x for x in fs.round_latencies]
    mr_ms = round_ms(times, mlog, n_rounds)
    buckets = collections.Counter((nb, eb) for nb, eb, _ in calls)
    log(f"fleet: {n_rounds} rounds (ticks {ticks[0]}..{t_last}; phase 6's "
        f"first inter-robot closure at round {first}, tick {t_first}), "
        f"{n_kf} keyframes in {wall:.2f} s; outcomes equal to phase 6's "
        f"through round {first}; final {outs}; own-keyframe ATE FleetSim / "
        f"phase 6 at tick {t_last}: "
        + ", ".join(f"robot {r} {a:.4f} / {b:.4f} m"
                    for r, (a, b) in enumerate(ates)))
    log(f"fleet: K1 launches {k1} ({k1_by}), K2 {k2} ({k2_by}), probes 0; "
        f"buckets (nb, eb) {dict(buckets)}; condense bands {bands}")
    log(f"fleet: round time (host clock, synchronized) FleetSim "
        f"{percentiles(fleet_ms)}; phase 6 over the same rounds (keyframes "
        f"+ exchange) {percentiles(mr_ms)}")


def _sharded_worker(rank, world, backend, shard):
    """One rank of (d): the edge-sharded dense and matrix-free solves of
    ``SHARD_BATCH``, each twice, on the card; the gathered poses and the
    seconds of each call."""
    from cg_mrslam_tpu_torch.parallel import sharding as SH
    from cg_mrslam_tpu_torch.sim.graphs import build_batch

    mesh = SH.make_mesh(world, shard=shard, backend=backend)
    gs = SH.shard_batch(build_batch(*SHARD_BATCH, device="cuda"), mesh)
    out = {}
    for name, solve in (("dense", SH.sharded_optimize),
                        ("pcg", SH.sharded_optimize_pcg)):
        for rep in range(2):
            poses, sec = timed_call(lambda: solve(gs, mesh), True)
            out[f"{name}{rep}"] = SH.gather_poses(poses, mesh).cpu().numpy()
            out[f"{name}{rep}_s"] = sec
    return out


def _fleet_worker(rank, world, states, conn, cfg):
    """One rank of (e): ``fleet_round_sharded`` of its robot on the card;
    its block as numpy dicts."""
    from torch.distributed.device_mesh import init_device_mesh

    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.parallel import fleet as F

    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("robots",))
    loc = len(states) // world
    mine = [convert.mr_state_from_numpy(s, "cuda")
            for s in states[rank * loc:(rank + 1) * loc]]
    out, sec = timed_call(lambda: F.fleet_round_sharded(
        F.stack_states(mine), conn, cfg, mesh), True)
    return [convert.to_numpy(st) for st in F.unstack_states(out, loc)], sec


def phase_sharded() -> None:
    """(d) The edge-sharded solves on the card: one process over NCCL, two
    processes on ``cuda:0`` over gloo; against the one-process solves of
    each graph (``gauss_newton.optimize``, ``pcg.optimize_pcg``) on the
    CPU."""
    from cg_mrslam_tpu_torch.core.graph import PoseGraph
    from cg_mrslam_tpu_torch.parallel.launch import run_group
    from cg_mrslam_tpu_torch.sim.graphs import build_batch
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.solver import pcg as PCG

    g = build_batch(*SHARD_BATCH, device="cpu")
    one = {"dense": [], "pcg": []}
    t0 = time.perf_counter()
    for b in range(g.poses.shape[0]):
        gb = PoseGraph(**{f: getattr(g, f)[b] for f in g.__dataclass_fields__})
        one["dense"].append(gn.optimize(gb, iterations=5).poses)
        one["pcg"].append(PCG.optimize_pcg(gb, iterations=5).poses)
    one = {k: torch.stack(v).numpy() for k, v in one.items()}
    log(f"sharded: the one-process solves of {SHARD_BATCH[0]} graphs, one "
        f"at a time on the CPU, in {time.perf_counter() - t0:.2f} s")
    for tag, world, backend in (("NCCL, 1 process", 1, "nccl"),
                                ("gloo, 2 processes on cuda:0", 2, "gloo")):
        t0 = time.perf_counter()
        res = run_group(_sharded_worker, world, args=(backend, world),
                        workdir=PHASE12_DIR / f"group-{backend}",
                        backend=backend, cuda_index=0,
                        timeout=GROUP_TIMEOUT)
        wall = time.perf_counter() - t0
        r0 = res[0]
        errs = {}
        for name in ("dense", "pcg"):
            for r in res:
                np.testing.assert_array_equal(r[f"{name}0"], r0[f"{name}0"])
            np.testing.assert_array_equal(r0[f"{name}1"], r0[f"{name}0"])
            d = wrap_angle(r0[f"{name}0"] - one[name])
            errs[name] = float(np.abs(d).max())
            assert errs[name] < 5e-3, (tag, name, errs[name])
        log(f"sharded ({tag}; {SHARD_BATCH[0]} graphs of {SHARD_BATCH[1]} "
            f"vertices, {SHARD_BATCH[2]} edges in {world} shard(s)): GN x5 "
            f"{1e3 * r0['dense1_s']:.1f} ms (first call "
            f"{1e3 * r0['dense0_s']:.1f} ms), PCG x5 (64 CG) "
            f"{1e3 * r0['pcg1_s']:.1f} ms; repeats bit-equal; largest "
            f"difference to the one-process solves: dense {errs['dense']:.2e}"
            f", PCG {errs['pcg']:.2e}; group wall {wall:.1f} s")


def phase_fleet_sharded(before) -> None:
    """(e) ``fleet_round_sharded`` on two processes on ``cuda:0`` over gloo,
    from phase 6's states before its first inter-robot closure, against
    ``fleet_round`` in this process."""
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.parallel import fleet as F
    from cg_mrslam_tpu_torch.parallel.launch import run_group

    cfg = deployment_config(2)
    path = PHASE12_DIR / "states_before_first_closure.npz"
    np.savez(path, conn=before["conn"], **{
        f"r{r}.{k}": v for r, st in enumerate(before["states"])
        for k, v in st.items()})
    z = dict(np.load(path))
    conn = z.pop("conn")
    states = [{k.split(".", 1)[1]: v for k, v in z.items()
               if k.startswith(f"r{r}.")} for r in range(2)]
    want, sec = timed_call(lambda: F.fleet_round(F.stack_states(
        [convert.mr_state_from_numpy(s, "cuda") for s in states]), conn,
        cfg), True)
    t0 = time.perf_counter()
    res = run_group(_fleet_worker, 2, args=(states, conn, cfg),
                    workdir=PHASE12_DIR / "group-fleet", backend="gloo",
                    cuda_index=0, timeout=GROUP_TIMEOUT)
    wall = time.perf_counter() - t0
    worst = 0.0
    for r, w in enumerate(F.unstack_states(want, 2)):
        worst = max(worst, flat_cmp(res[r][0][0], convert.to_numpy(w)))
    outs = [outcomes(st) for st in F.unstack_states(want, 2)]
    assert any(o["inter_closures"] for o in outs), outs
    log(f"fleet sharded: the round of tick {before['tick']} on 2 gloo "
        f"processes on cuda:0 equals fleet_round in process (ints equal, "
        f"largest float difference {worst:.3g}); outcomes {outs}; "
        f"fleet_round {1e3 * sec:.1f} ms, sharded round "
        f"{1e3 * max(r[1] for r in res):.1f} ms, group wall {wall:.1f} s")


def merged_graph(device):
    """``tests/fixtures/merged_2robot_1024.npz`` as ``test_merged_parity.py``
    loads it (edge capacity cut to the live edges rounded up to 128), with
    its (owner, keyframe) order."""
    from cg_mrslam_tpu_torch.core.graph import PoseGraph
    from cg_mrslam_tpu_torch.solver.chain import chain_order

    z = dict(np.load(MERGED))
    e_cap = int(-(-int(z["n_edges"]) // 128) * 128)
    f32 = {"poses", "e_z", "e_info"}
    kw = {}
    for f in PoseGraph.__dataclass_fields__:
        a = z[f][:e_cap] if f.startswith("e_") or f == "emask" else z[f]
        kw[f] = torch.as_tensor(np.asarray(
            a, np.float32 if f in f32 else None), device=device)
        if kw[f].dtype == torch.int64:
            kw[f] = kw[f].to(torch.int32)
    g = PoseGraph(**kw)
    order = chain_order(*(torch.as_tensor(z[k], device=device).to(
        torch.int32 if k != "vmask" else torch.bool)
        for k in ("v_owner", "v_remote", "vmask")))
    return g, order


def phase_merged() -> None:
    """The merged 1024 fixture's chain-preconditioned PCG solve (5 GN
    iterations of 96 CG) on the card against the CPU's, per iteration."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.solver.pcg import optimize_pcg

    chis, secs = {}, []
    for dev in ("cpu", "cuda"):
        g, order = merged_graph(dev)
        if dev == "cuda":
            band = int(gn.auto_backend(g, order=order))
        chis[dev] = [float(chi2(g))]
        with (hvp_counted("12 merged 1024") if dev == "cuda"
              else contextlib.nullcontext()):
            for _ in range(5):
                g, sec = timed_call(lambda: optimize_pcg(
                    g, iterations=1, cg_iters=96, order=order), dev == "cuda")
                chis[dev].append(float(chi2(g)))
                if dev == "cuda":
                    secs.append(sec)
    for a, b in zip(chis["cuda"], chis["cpu"]):
        assert abs(a - b) <= 0.01 * b, (chis["cuda"], chis["cpu"])
    assert abs(chis["cuda"][-1] - 12.796) < 0.13, chis["cuda"]
    log(f"merged 1024: chi2 per iteration card {chis['cuda']}, CPU "
        f"{chis['cpu']} (within 1%); band {band} (0 dense, 1 chain, 2 PCG; "
        f"optimize_auto's choice at capacity {g.poses.shape[0]}); PCG "
        f"iteration on the card {', '.join(f'{1e3 * s:.1f}' for s in secs)}"
        f" ms")


def phase_parallel(slam, cfg, traj, fov, infos, kf_t, sim, mlog, times,
                   first, before, records) -> None:
    """Phase 12 (see the module docstring)."""
    for name, fn in (
            ("viz", lambda: phase_viz(slam)),
            ("stream", lambda: phase_stream(cfg, traj, fov, infos, kf_t)),
            ("fleet", lambda: phase_fleet(sim, mlog, times, first, records)),
            ("sharded", phase_sharded),
            ("fleet sharded", lambda: phase_fleet_sharded(before)),
            ("merged", phase_merged)):
        t0 = time.perf_counter()
        fn()
        log(f"{name}: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phase 13


def take(g, idx):
    """Graphs ``idx`` of a batch (an int: one graph, batch-1)."""
    from cg_mrslam_tpu_torch.core.graph import PoseGraph

    return PoseGraph(**{f.name: getattr(g, f.name)[idx]
                        for f in dataclasses.fields(g)})


def to_cpu(g):
    from cg_mrslam_tpu_torch.core.graph import PoseGraph

    return PoseGraph(**{f.name: getattr(g, f.name).cpu()
                        for f in dataclasses.fields(g)})


def bench_timed(fn, g, reps: int = 4):
    """``bench.py:175``'s ``timed``: one warm-up call on ``g``, then the
    median wall seconds over ``reps`` calls on distinct inputs (poses +
    1e-4·(k+1)), the card synchronized around each. Returns ``(seconds,
    the warm-up call's output, all seconds)``."""
    first = fn(g)
    torch.cuda.synchronize()
    ts = []
    for k in range(reps):
        gi = dataclasses.replace(g, poses=g.poses + 1e-4 * (k + 1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(gi)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), first, ts


def chain_close(got: float, want: float, start: float) -> bool:
    """Two chain solves' chi2 agree (:data:`CHAIN_CONVERGED`)."""
    return (abs(got - want) <= 0.01 * want
            or max(got, want) <= CHAIN_CONVERGED * start)


def pose_errs(a: torch.Tensor, b) -> torch.Tensor:
    """Per graph of ``a [..., N, 3]``, the largest pose difference to ``b``
    (angles wrapped)."""
    d = a.detach().cpu().double() - torch.as_tensor(b).double()
    d[..., 2] = torch.remainder(d[..., 2] + math.pi, 2 * math.pi) - math.pi
    return d.abs().flatten(-2).amax(-1)


def pose_err(a: torch.Tensor, b) -> float:
    """The largest pose difference of two ``[..., N, 3]`` sets."""
    return float(pose_errs(a, b).max())


def solves_line(name, batch, sec, secs, c0, c1) -> dict:
    rec = {"workload": name, "graphs": batch, "seconds": sec,
           "seconds_runs": secs, "solves_per_s": batch / sec,
           "chi2_start_mean": float(c0.mean()),
           "chi2_end_mean": float(c1.mean()),
           "chi2_end_max": float(c1.max())}
    log(f"bench {name}: {batch} graphs, {sec:.4f} s (median of "
        f"{', '.join(f'{t:.4f}' for t in secs)}), {batch / sec:.1f} "
        f"solves/s; chi2 mean {rec['chi2_start_mean']:.6g} -> "
        f"{rec['chi2_end_mean']:.6g} (max {rec['chi2_end_max']:.6g})")
    return rec


def bench_dense(out: list) -> None:
    """(a) The dense band: ``gn.optimize`` (SPD inverse, ``chol`` off) of
    ``build_batch(1024)``, and the dense reference point at hospital
    scale."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.sim.graphs import (build_batch,
                                                build_hospital_batch)
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    g = build_batch(1024, device="cuda")
    step = lambda x: gn.optimize(x, 5)                   # noqa: E731
    sec, a, secs = bench_timed(step, g)
    assert torch.equal(a.poses, step(g).poses), "dense solve not repeatable"
    c0, c1 = chi2(g), chi2(a)
    assert bool(torch.all(c1 < c0)), (c0, c1)
    worst = 0.0
    for k in range(8):
        one = gn.optimize(to_cpu(take(g, k)), 5)
        d = a.poses[k].cpu().double() - one.poses.double()
        d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
        worst = max(worst, float(d.abs().max()))
    assert worst <= 1e-4, worst
    rec = solves_line("dense GN x5 (build_batch 1024: 64 vertices, 128 "
                      "edges; SPD inverse)", 1024, sec, secs, c0, c1)
    rec["cpu_batch1_max_pose_diff"] = worst
    out.append(rec)
    log(f"bench dense: 8 graphs within {worst:.3g} of batch-1 CPU solves; "
        f"two calls equal to the bit")

    g = build_hospital_batch(16, device="cuda")
    sec, a, secs = bench_timed(step, g, reps=1)
    out.append(solves_line("dense reference point GN x5 (16 x 1024-pose "
                           "hospital; SPD inverse)", 16, sec, secs, chi2(g),
                           chi2(a)))


def bench_chain(out: list) -> None:
    """(b) The chain band: ``optimize_chain`` of 512 hospital graphs at the
    bench's operating point; then graph 0 with a CG schedule and with a
    frozen preconditioner."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.sim.graphs import (build_hospital_batch,
                                                hospital_truth)
    from cg_mrslam_tpu_torch.solver import chain as CH

    g = build_hospital_batch(512, device="cuda")
    step = lambda x: CH.optimize_chain(x, 5, return_dropped=True,  # noqa
                                       **CHAIN_KW)
    sec, (a, dropped), secs = bench_timed(step, g)
    assert torch.equal(a.poses, step(g)[0].poses), "chain solve not repeatable"
    assert int(dropped.max()) == 0, dropped
    c0, c1 = chi2(g), chi2(a)
    assert bool(torch.isfinite(c1).all())
    assert float(c1.mean()) < 0.05 * float(c0.mean()), (c0.mean(), c1.mean())
    rec = solves_line("chain GN x5 (512 x 1024-pose hospital, cg 24, tol "
                      "1e-4, loop cap 64)", 512, sec, secs, c0, c1)
    truth = hospital_truth(g.poses.shape[-2])
    dist = pose_errs(a.poses, truth)
    q = {f"p{int(100 * x)}": float(torch.quantile(dist, x))
         for x in (0.5, 0.9, 0.99)}
    q["max"] = float(dist.max())
    assert q["p50"] <= CHAIN_POSES, q
    rec["optimum_max_pose_diff_quantiles"] = q
    cpu, errs = [], []
    for k in (0, 1):
        one = CH.optimize_chain(to_cpu(take(g, k)), 5, **CHAIN_KW)
        ck, want = float(c1[k]), float(chi2(one))
        cpu.append(want)
        errs.append((float(dist[k]), pose_err(one.poses, truth)))
        assert chain_close(ck, want, float(c0[k])), (k, ck, want)
    rec["cpu_batch1_chi2"] = cpu
    rec["optimum_max_pose_diff_card_cpu"] = errs
    # two graphs with 12 closures in float64 against the CPU
    g64 = build_hospital_batch(2, closures=12, device="cuda")
    g64 = dataclasses.replace(g64, **{f: getattr(g64, f).double()
                                      for f in ("poses", "e_z", "e_info")})
    card64 = CH.optimize_chain(g64, 5, **CHAIN_KW).poses
    cpu64 = CH.optimize_chain(to_cpu(g64), 5, **CHAIN_KW).poses
    e64 = pose_err(card64, cpu64)
    assert e64 <= CHAIN_POSES_F64, e64
    rec["float64_12_closures_max_pose_diff"] = e64
    log(f"bench chain: dropped 0; graphs 0, 1 chi2 {float(c1[0]):.6g}, "
        f"{float(c1[1]):.6g} on the card, {cpu[0]:.6g}, {cpu[1]:.6g} as "
        f"batch-1 CPU solves, poses within {errs[0][0]:.3g}, "
        f"{errs[1][0]:.3g} of the optimum ({errs[0][1]:.3g}, "
        f"{errs[1][1]:.3g} on the CPU); the 512 graphs' distance from the "
        f"optimum p50 {q['p50']:.3g}, p90 {q['p90']:.3g}, p99 "
        f"{q['p99']:.3g}, max {q['max']:.3g}; two 12-closure graphs in "
        f"float64 within {e64:.3g} of the CPU's; two calls equal to the bit")
    g0 = take(g, slice(0, 1))
    c00 = float(chi2(g0)[0])
    for name, kw in (("cg_schedule (48, 24, 16, 12, 12)",
                      dict(cg_schedule=(48, 24, 16, 12, 12), cg_iters=48,
                           cg_tol=1e-4, loop_cap=64)),
                     ("freeze_precond", dict(freeze_precond=True, **CHAIN_KW))):
        CH.FREEZE_REDOS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = CH.optimize_chain(g0, 5, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = float(chi2(o)[0])
        redos = CH.FREEZE_REDOS["optimize_chain"]
        e = pose_err(o.poses[0], truth)
        assert math.isfinite(c) and c < 1e-3 * c00, (name, c, c00)
        rec[name] = {"chi2": c, "seconds": dt, "redone_iterations": redos,
                     "optimum_max_pose_diff": e}
        log(f"bench chain graph 0, {name}: chi2 {c00:.6g} -> {c:.6g} in "
            f"{dt:.3f} s, poses within {e:.3g} of the optimum; the guard "
            f"redid {redos} iteration(s)")
    out.append(rec)


def bench_merged(out: list) -> None:
    """(c) The PCG band on the merged two-robot fixture: 512 graphs, then
    4096 as 8 chunks of 512 in a host loop."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.solver.pcg import optimize_pcg

    g, order, meta = build_merged_batch(512, device="cuda")
    band = int(gn.auto_backend(take(g, 0), loop_cap=64, order=order))
    assert band == 2, band
    step = lambda x: optimize_pcg(x, 5, order=order,     # noqa: E731
                                  cg_iters=MERGED_PCG_ITERS)
    with hvp_counted("13c merged 512"):
        sec, a, secs = bench_timed(step, g)
    c0, c1 = chi2(g), chi2(a)
    assert bool(torch.isfinite(c1).all())
    assert float(c1.mean()) < 1e-3 * float(c0.mean()), (c0.mean(), c1.mean())
    rec = solves_line("merged PCG GN x5 (512 x merged 2-robot 1024, cg 8)",
                      512, sec, secs, c0, c1)
    cpu = []
    for k in (0, 1):
        one = optimize_pcg(to_cpu(take(g, k)), 5, order=order.cpu(),
                           cg_iters=MERGED_PCG_ITERS)
        want = float(chi2(one))
        cpu.append(want)
        assert abs(float(c1[k]) - want) <= 0.01 * want, (k, c1[k], want)
    rec.update(meta, band=band, cpu_batch1_chi2=cpu,
               chi2_element0=float(c1[0]), dense_cpu_oracle=MERGED_ORACLE)
    log(f"bench merged: band {band} (PCG); element 0 chi2 "
        f"{float(c1[0]):.4f} beside the dense CPU oracle {MERGED_ORACLE}; "
        f"graphs 0, 1 on the CPU {cpu[0]:.4f}, {cpu[1]:.4f}")
    out.append(rec)
    del g, a

    g, order, _ = build_merged_batch(4096, device="cuda")
    n = g.poses.shape[0]
    chunks = [take(g, slice(k, k + 512)) for k in range(0, n, 512)]

    def run(chs):
        return [step(c).poses for c in chs]

    shifted = [dataclasses.replace(c, poses=c.poses + 1e-4) for c in chunks]
    with hvp_counted("13c merged 4096 in chunks"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = torch.cat(run(shifted))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    c0 = chi2(dataclasses.replace(g, poses=g.poses + 1e-4))
    c1 = chi2(dataclasses.replace(g, poses=poses))
    assert bool(torch.isfinite(c1).all())
    assert float(c1.mean()) < 1e-3 * float(c0.mean()), (c0.mean(), c1.mean())
    out.append(solves_line(f"merged PCG GN x5, {n} graphs ({len(chunks)} "
                           f"chunks of 512, one timed call)", n, sec, [sec],
                           c0, c1))


def bench_pcg_64k(out: list) -> None:
    """(d) Matrix-free PCG on one 65,536-pose graph."""
    from cg_mrslam_tpu_torch.core.linearize import chi2
    from cg_mrslam_tpu_torch.sim.graphs import build_hospital_batch
    from cg_mrslam_tpu_torch.solver.pcg import optimize_pcg

    g = take(build_hospital_batch(1, n=65536, closures=1024, seed=1,
                                  device="cuda"), 0)
    step = lambda x: optimize_pcg(x, 5, cg_iters=96)     # noqa: E731
    with hvp_counted("13d pcg 64k"):
        sec, a, secs = bench_timed(step, g, reps=2)
    c0, c1 = chi2(g), chi2(a)
    assert math.isfinite(float(c1)) and float(c1) < 1e-3 * float(c0), (c0, c1)
    out.append(solves_line("PCG GN x5 (one 65,536-pose graph, 1024 "
                           "closures, cg 96)", 1, sec, secs, c0[None],
                           c1[None]))


def bench_gauge(out: list, matches) -> None:
    """(e) The batched optimal gauge at phase 6's first star: every
    candidate's uncertainty against a condense of that candidate alone
    on the card, and the gauge against the CPU's."""
    from cg_mrslam_tpu_torch import convert
    from cg_mrslam_tpu_torch.core.graph import unpack_info
    from cg_mrslam_tpu_torch.mr import condensed as CG
    from cg_mrslam_tpu_torch.mr import mrslam as MR
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    t, st, peer, n_req = first_star(matches)
    g, slots, valid, own, order, _ = MR.star_inputs(st, peer)
    k = int(valid.sum())

    def loop():
        """One batch-1 condense of each valid candidate (the cost that the
        batch replaces)."""
        u1 = []
        for j in range(valid.shape[0]):
            if not bool(valid[j]):
                u1.append(float("inf"))
                continue
            star = CG.condense(g, slots, valid, slots[j], own, order)
            det = torch.linalg.det(unpack_info(star.info))
            inv = 1.0 / torch.clamp(det, min=1e-30)
            u1.append(float(torch.sum(torch.where(star.valid, inv,
                                                  torch.zeros_like(inv)))))
        return u1

    batched = lambda: CG.condense_optimal(g, slots, valid,  # noqa: E731
                                          own, order)
    batched()                     # warm-up of both, then one timed call each
    loop()
    gn.BAND_CALLS.clear()
    (star, u), sec = timed_call(batched, True)
    bands = dict(gn.BAND_CALLS)
    u1, loop_sec = timed_call(loop, True)
    u = u.cpu().double().numpy()
    u1 = np.asarray(u1)
    live = np.isfinite(u1)
    rel = np.abs(u[live] - u1[live]) / np.abs(u1[live])
    assert np.all(np.isinf(u[~live])), u
    assert np.all(rel <= 1e-4), (u, u1)
    gauge = int(star.gauge)
    cpu = torch.device("cpu")
    st_cpu = convert.mr_state_from_numpy(convert.to_numpy(st), cpu)
    gc, sc, vc, oc, orc, _ = MR.star_inputs(st_cpu, peer)
    gauge_cpu = int(CG.condense_optimal(gc, sc, vc, oc, orc)[0].gauge)
    assert gauge == gauge_cpu, (gauge, gauge_cpu)
    out.append({"workload": "optimal gauge (batched condense)", "tick": t,
                "candidates": k, "requested": n_req, "seconds": sec,
                "per_candidate_loop_seconds": loop_sec,
                "max_rel_diff": float(rel.max()), "gauge": gauge,
                "bands": {f"{e} {b}": v for (e, b), v in bands.items()}})
    log(f"bench gauge: tick {t}, K = {k} candidates ({n_req} requested); "
        f"batched {sec:.3f} s against {loop_sec:.3f} s for the per-candidate "
        f"loop (host clock, synchronized; bands {bands}); uncertainties "
        f"within {rel.max():.3g} relative; gauge {gauge} on the card and "
        f"the CPU")

    # the benchmark cell's star: 128 candidates on the merged fixture
    g, slots, own, order = merged_star_inputs(STAR_CELL_K)
    valid = torch.ones(STAR_CELL_K, dtype=torch.bool, device="cuda")
    gn.BAND_CALLS.clear()
    torch.cuda.reset_peak_memory_stats()
    with hvp_counted("13e star 128"):
        (star, u), sec = timed_call(
            lambda: CG.condense_optimal(g, slots, valid, own, order), True)
    peak = torch.cuda.max_memory_allocated()
    bands = dict(gn.BAND_CALLS)
    assert set(b for _, b in bands) == {"pcg"}, bands
    assert bool(torch.isfinite(u).all()) and bool(
        torch.isfinite(star.z).all()) and bool(torch.isfinite(
            star.info).all())
    out.append({"workload": "optimal gauge, the benchmark cell's star "
                            "(128 candidates, merged fixture)",
                "candidates": STAR_CELL_K, "seconds": sec,
                "peak_bytes": int(peak), "gauge": int(star.gauge),
                "bands": {f"{e} {b}": v for (e, b), v in bands.items()}})
    log(f"bench gauge: the cell's star, K = {STAR_CELL_K} on the merged "
        f"fixture: {sec:.3f} s, peak {peak / 1e9:.2f} GB, gauge "
        f"{int(star.gauge)}, bands {bands}")


def merged_star_inputs(k: int):
    """The merged fixture's graph on the card, robot 0's own edges, its
    (owner, keyframe) order and the ``k`` newest robot-0 vertices of its
    inter-robot closures (the benchmark cell's request)."""
    from cg_mrslam_tpu_torch.core.graph import own_edge_mask
    from cg_mrslam_tpu_torch.sim.graphs import build_merged_batch

    gb, order, _ = build_merged_batch(1, device="cuda")
    g = take(gb, 0)
    z = np.load(MERGED)
    vo, vr = z["v_owner"], z["v_remote"]
    ij = g.e_ij[g.emask].cpu().numpy()
    ends = np.unique(ij[vo[ij[:, 0]] != vo[ij[:, 1]]])
    mine = ends[vo[ends] == 0]
    slots = mine[np.argsort(-vr[mine], kind="stable")][:k]
    return (g, torch.as_tensor(slots.astype(np.int32), device="cuda"),
            own_edge_mask(g, 0), order)


def bench_sol(out: list) -> None:
    """(f) ``utils/sol.report()`` on the card."""
    from cg_mrslam_tpu_torch.utils import sol

    rows = sol.report(reps=2)
    for r in rows:
        log("sol " + json.dumps(r))
        for key, v in r.items():
            if key.startswith("of_") or key == "sol_fraction":
                assert 0 < v <= 1.05, (r["kernel"], key, v)
    out.append({"workload": "sol", "rows": rows})


def bench_latency(out: list, ticks: int = LATENCY_TICKS):
    """(g) ``srslam`` at capacity 1024 (``bench.py:330-351``) on the card to
    the end of the route or ``ticks``. Returns K1's launches by shape."""
    from cg_mrslam_tpu_torch.config import Config, MatcherConfig, SlamConfig
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.sim import world as W
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn

    cfg = Config(slam=SlamConfig(),
                 close_matcher=MatcherConfig(extent=30.0, resolution=0.025,
                                             kernel_radius=0.2),
                 lc_matcher=MatcherConfig(extent=70.0, resolution=0.1,
                                          kernel_radius=0.5),
                 max_vertices=1024, max_edges=4096)
    world = W.hospital_world(40.0, 20.0, seed=0)
    fov = 2 * np.pi * 0.75
    traj = W.simulate_robot(world, W.corridor_waypoints(40.0, 20.0, 0, 4),
                            seed=1, beams=360, fov=fov, max_range=10.0,
                            odom_noise=(0.01, 0.004), device="cuda")
    n_ticks = min(ticks, len(traj.gt))
    K.SCORE_VOLUME.launches = 0
    K.SCORE_VOLUME.launches_by_shape.clear()
    gn.BAND_CALLS.clear()
    t0 = time.perf_counter()
    slam, kf_t, lat = run_slice(cfg, traj, fov, "cuda", max_ticks=n_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.SCORE_VOLUME.launches
    by_shape = dict(K.SCORE_VOLUME.launches_by_shape)
    bands = dict(gn.BAND_CALLS)
    infos = slam.infos
    n_kf = len(infos)
    closures = sum(i.closures_added for i in infos)
    gt = traj.gt[kf_t]
    a_slam, a_odom = ate(slam.poses, gt), ate(traj.odom[kf_t], gt)
    backends = collections.Counter(i.solver_backend for i in infos)
    first_1024 = int(kf_t[sum(len(v) for b, v in lat.items() if b < 1024)
                          + 1]) if 1024 in lat else None
    log(f"bench latency: srslam at capacity 1024, {n_ticks} of "
        f"{len(traj.gt)} ticks (the first keyframe in bucket 1024 at tick "
        f"{first_1024}), {n_kf} keyframes in {wall:.2f} s; K1 "
        f"launches {launches}; closures {closures}; final chi2 "
        f"{infos[-1].chi2:.4f}; ATE {a_slam:.4f} m vs odometry ATE "
        f"{a_odom:.4f} m; backends per keyframe {dict(backends)}; solver "
        f"bands {bands}")
    per_bucket = {}
    for b in sorted(lat):
        v = np.asarray(lat[b]) * 1e3
        per_bucket[str(b)] = {"n": len(v),
                              "p50_ms": float(np.percentile(v, 50)),
                              "p99_ms": float(np.percentile(v, 99)),
                              "max_ms": float(v.max())}
        log(f"bench latency: bucket {b}: {len(v)} keyframes, p50 "
            f"{np.percentile(v, 50):.2f} ms, p99 {np.percentile(v, 99):.2f} "
            f"ms, max {v.max():.2f} ms (host clock, synchronized)")
    assert launches == 3 * n_kf, (launches, n_kf)
    assert all(np.isfinite(i.chi2) for i in infos)
    assert closures >= 1, closures
    assert a_slam < a_odom, (a_slam, a_odom)
    assert 1024 in lat and len(lat[1024]) >= 60, sorted(lat)
    banded = sum(v for (e, b), v in bands.items()
                 if e == "optimize_auto" and b in ("chain", "pcg"))
    assert banded >= len(lat[1024]) and backends[0] < n_kf, (bands, backends)
    out.append({"workload": "srslam keyframe latency at capacity 1024",
                "ticks": n_ticks, "route_ticks": len(traj.gt),
                "keyframes": n_kf, "seconds": wall, "closures": closures,
                "ate_m": a_slam, "odometry_ate_m": a_odom,
                "final_chi2": float(infos[-1].chi2),
                "backends": {str(k): v for k, v in backends.items()},
                "bands": {f"{e} {b}": v for (e, b), v in bands.items()},
                "per_bucket": per_bucket})
    return by_shape


def bench_hvp(out: list) -> list:
    """(h) The PCG band's Hessian-vector kernel pair at the benchmark's
    shapes, against its plain version; returns its kernel records."""
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.ops import pcg_hvp as PH
    from tools.bench_pcg_hvp import hvp_records

    t0 = time.perf_counter()
    PH.PCG_HVP._entry(torch.float32)
    log(f"bench hvp: pcg_hvp.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s; ptxas -v:\n"
        f"{K.ptxas_report(PH.SRC)}")
    recs = hvp_records(2048)
    for rec in recs:
        rec.update(route="cuda", source="cg_mrslam_tpu_torch/csrc/pcg_hvp.cu",
                   replaces="none (the JAX package leaves the product to XLA)",
                   library_ms=None)
        log(f"bench hvp: {rec['name']} {rec['shape']}: ms {rec['ms']:.4f}, "
            f"device_ms {rec['device_ms']:.5f}, host_us "
            f"{rec['host_us']:.1f}, bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']} (the split's scratch adds "
            f"{rec['scratch_ms']:.5f} ms), plain {rec['plain_ms']:.3f} ms, "
            f"{rec['device_ops_per_call']:.0f} device ops a call, error "
            f"{rec['err_over_bar']:.3g} of the bar")
    out.extend(recs)
    return recs


def bench_cr_apply(out: list) -> list:
    """(i) The PCG preconditioner's cyclic-reduction kernel at the
    benchmark's shapes (``fleet_pcg``'s and the star's), on a
    65,536-pose graph and in float64, against its plain version; returns
    its kernel records."""
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.ops import cr_apply as CA
    from tools.bench_cr_apply import cr_edge_records, cr_records

    t0 = time.perf_counter()
    CA.CR_APPLY._entry(torch.float32)
    log(f"bench cr_apply: cr_apply.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s; ptxas -v:\n"
        f"{K.ptxas_report(CA.SRC)}")
    recs = cr_records(2048, 128)
    for rec in recs:
        rec.update(route="cuda", source="cg_mrslam_tpu_torch/csrc/cr_apply.cu",
                   replaces="none (the JAX package leaves the solve to XLA)",
                   library_ms=None)
        log(f"bench cr_apply: {rec['name']} {rec['shape']}: ms "
            f"{rec['ms']:.4f}, device_ms {rec['device_ms']:.5f}, host_us "
            f"{rec['host_us']:.1f}, bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']} ({100 * rec['bound_share']:.1f}% of it), "
            f"plain {rec['plain_ms']:.3f} ms, "
            f"{rec['device_ops_per_call']:.0f} device ops a call, error "
            f"{rec['err']:.3g} (plain {rec['err_plain']:.3g}, scale "
            f"{rec['scale']:.3g}), plan {rec['plan']}")
    for rec in cr_edge_records():
        log(f"bench cr_apply: {rec['name']} {rec['shape']}: error "
            f"{rec['err']:.3g} (plain {rec['err_plain']:.3g}, scale "
            f"{rec['scale']:.3g}), plan {rec['plan']}")
        out.append(rec)
    out.extend(recs)
    return recs


def bench_cg_update(out: list) -> list:
    """(j) The PCG loop's two vector updates checked at the benchmark's
    shapes, on a split 65,536-pose system and in float64, against their
    plain version, then timed there; returns their kernel records."""
    from cg_mrslam_tpu_torch.ops import cg_update as CU
    from cg_mrslam_tpu_torch.ops import correlate as K
    from tools.bench_cg_update import check_records, records, shapes

    t0 = time.perf_counter()
    CU.CG_UPDATE._entries(torch.float32)
    log(f"bench cg_update: cg_update.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s; ptxas -v:\n"
        f"{K.ptxas_report(CU.SRC)}")
    for rec in check_records():
        log(f"bench cg_update: {rec['name']}: plan {rec['plan']}, error "
            f"over the scale x {rec['err_x']:.3g}, r {rec['err_r']:.3g}, p "
            f"{rec['err_p']:.3g}, rz {rec['err_rz']:.3g}; {rec['froze']} "
            f"systems froze in the calls; rehearsed {rec['rehearsed']}")
        out.append(rec)
    recs = [rec for shape in shapes(2048, 128) for rec in records(*shape)]
    for rec in recs:
        rec.update(route="cuda", source="cg_mrslam_tpu_torch/csrc/"
                   "cg_update.cu", replaces="none (the JAX package leaves "
                   "the CG body to XLA)", library_ms=None)
        log(f"bench cg_update: {rec['name']} {rec['shape']}: ms "
            f"{rec['ms']:.4f}, device_ms {rec['device_ms']:.5f}, host_us "
            f"{rec['host_us']:.1f}, bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']} ({100 * rec['bound_share']:.1f}% of it), "
            f"plain {rec['plain_ms']:.3f} ms, "
            f"{rec['device_ops_per_call']:.0f} device ops a call "
            f"(plain {rec['plain_device_ops_per_call']:.0f}), plan "
            f"{rec['plan']}")
    out.extend(recs)
    return recs


def phase_bench(matches) -> tuple:
    """Phase 13 (see the module docstring). Writes every workload's record
    to ``chiprun_out/phase13/bench.json``; returns K1's launches by shape
    in (g), and (h), (i) and (j)'s kernel records."""
    PHASE13_DIR.mkdir(parents=True, exist_ok=True)
    out, by_shape, hvp = [], {}, []
    for name, fn in (("dense", lambda: bench_dense(out)),
                     ("chain", lambda: bench_chain(out)),
                     ("merged", lambda: bench_merged(out)),
                     ("pcg 64k", lambda: bench_pcg_64k(out)),
                     ("gauge", lambda: bench_gauge(out, matches)),
                     ("sol", lambda: bench_sol(out)),
                     ("latency", lambda: by_shape.update(bench_latency(out))),
                     ("hvp", lambda: hvp.extend(bench_hvp(out))),
                     ("cr_apply", lambda: hvp.extend(bench_cr_apply(out))),
                     ("cg_update",
                      lambda: hvp.extend(bench_cg_update(out)))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        log(f"bench {name}: {time.perf_counter() - t0:.1f} s")
    (PHASE13_DIR / "bench.json").write_text(json.dumps(out, indent=1))
    return by_shape, hvp


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import cg_mrslam_tpu_torch.matcher.search as search
    from cg_mrslam_tpu_torch.ops import correlate as K
    from cg_mrslam_tpu_torch.solver import gauss_newton as gn
    from cg_mrslam_tpu_torch.utils import cuda_timing as CT

    # --- 1. the card ---
    card = CT.card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    # --- 2. build ---
    t0 = time.perf_counter()
    K.load_library()
    log(f"build: score_volume.cu (K1, K2, the pair, the probes) in "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"ptxas -v:\n{K.ptxas_report()}")
    ghz = CT.max_sm_clock_ghz()
    log(f"max SM clock {ghz:.3f} GHz (the issue floor's clock)")
    probes = (K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS)

    # --- 3. the slice on the card ---
    t0 = time.perf_counter()
    cfg, traj, fov = srslam_setup()
    log(f"sim: {len(traj.gt)} ticks, {traj.ranges.shape[1]} beams in "
        f"{time.perf_counter() - t0:.2f} s")
    capture = Capture(K.SCORE_VOLUME, k1_name, SHAPES)
    search.SCORE_VOLUME = capture
    for k in (K.SCORE_VOLUME,) + probes:
        k.launches = 0
        k.launches_by_shape.clear()
    t0 = time.perf_counter()
    slam, kf_t, lat = run_slice(cfg, traj, fov, "cuda", capture=capture)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.SCORE_VOLUME.launches
    by_shape = dict(K.SCORE_VOLUME.launches_by_shape)
    assert all(k.launches == 0 for k in probes), "a probe ran on the path"
    search.SCORE_VOLUME = K.SCORE_VOLUME
    n_kf = len(slam.infos)
    infos = slam.infos
    closures = sum(i.closures_added for i in infos)
    gt = traj.gt[kf_t]
    ate_slam = ate(slam.poses, gt)
    ate_odom = ate(traj.odom[kf_t], gt)
    log(f"slice: {n_kf} keyframes ({slam.poses.shape[0]} vertices of "
        f"{cfg.max_vertices}) in {wall:.2f} s; score_volume launches "
        f"{launches} ({by_shape}); closures {closures}; "
        f"sm_accepted {sum(bool(i.sm_accepted) for i in infos)}; "
        f"final chi2 {infos[-1].chi2:.4f}")
    log(f"slice: ATE {ate_slam:.4f} m vs odometry ATE {ate_odom:.4f} m")
    backends = collections.Counter(i.solver_backend for i in infos)
    log(f"slice: solver backend per keyframe {dict(backends)} (0 dense "
        f"Cholesky, 1 chain, 2 PCG)")
    for b in sorted(lat):
        v = np.asarray(lat[b]) * 1e3
        log(f"slice: bucket {b}: {len(v)} keyframes, latency p50 "
            f"{np.percentile(v, 50):.2f} ms, p99 {np.percentile(v, 99):.2f} "
            f"ms, max {v.max():.2f} ms")
    assert n_kf >= 300, n_kf
    assert set(backends) == {0}, backends
    assert 512 in lat and 256 in lat, sorted(lat)
    assert launches == 3 * n_kf, (launches, n_kf)
    assert all(np.isfinite(i.chi2) for i in infos)
    assert closures >= 1, closures
    assert ate_slam < ate_odom, (ate_slam, ate_odom)

    # --- 4. the kernel at the main-path shapes ---
    assert sorted(capture.calls) == sorted(SHAPES), sorted(capture.calls)
    records, probe_records = [], []
    for name in SHAPES:
        args = capture.calls[name]
        dev = args[0].device
        ty, tx = lattice(args[6], 1, dev), lattice(args[7], 1, dev)
        rec = check_kernel(K.SCORE_VOLUME, args, ty, tx)
        key = tuple(rec["shape"])
        rec = {"name": f"score_volume[{name}]", "route": "cuda",
               "source": SOURCE, "replaces": REPLACES,
               "launches": by_shape[key],
               "launches_per_keyframe": by_shape[key] / n_kf,
               "captured_at_keyframe": capture.keyframe[name], **rec}
        assert by_shape[key] == n_kf, (name, by_shape[key], n_kf)
        records.append(rec)
        log(kernel_line(rec, ghz) + f" (keyframe {rec['captured_at_keyframe']}, "
            f"{rec['live_volumes']} live volumes, spread "
            f"{rec['spread_dy']:.4g}/{rec['spread_dx']:.4g})")
        for pr in check_probes(args, ty, tx, name):
            probe_records.append(pr)
            log(kernel_line(pr, ghz))

    # --- 5. the first keyframes on the CPU ---
    t0 = time.perf_counter()
    torch.set_num_threads(8)
    cpu, cpu_kf_t, _ = run_slice(cfg, traj, fov, "cpu",
                                 max_keyframes=N_CPU_KEYFRAMES)
    np.testing.assert_array_equal(cpu_kf_t, kf_t[:len(cpu_kf_t)])
    for k, (a, b) in enumerate(zip(cpu.infos, infos)):
        assert a.sm_accepted == b.sm_accepted, k
        d = np.asarray(a.pose, np.float64) - np.asarray(b.pose, np.float64)
        d[2] = (d[2] + np.pi) % (2 * np.pi) - np.pi
        assert np.all(np.abs(d) <= 1e-3), (k, d)
    log(f"cpu replay: {len(cpu.infos)} keyframes agree with the card "
        f"(1e-3 m / 1e-3 rad) in {time.perf_counter() - t0:.2f} s")

    # --- 6. the multi-robot deployment on the card ---
    capture2 = Capture(K.SCORE_VOLUME_STRIDED, k2_name, STRIDED)
    search.SCORE_VOLUME_STRIDED = capture2
    for k in (K.SCORE_VOLUME, K.SCORE_VOLUME_STRIDED) + probes:
        k.launches = 0
        k.launches_by_shape.clear()
    gn.BAND_CALLS.clear()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    matches = MatchCapture()
    before = {}
    with hvp_counted("6 cg_mrslam"):
        sim, times, mlog = run_mr("cuda", capture=capture2, matches=matches,
                                  before_closure=before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_mr = K.SCORE_VOLUME.launches
    k2_launches = K.SCORE_VOLUME_STRIDED.launches
    k2_by = dict(K.SCORE_VOLUME_STRIDED.launches_by_shape)
    probe_launches = sum(k.launches for k in probes)
    bands = dict(gn.BAND_CALLS)
    search.SCORE_VOLUME_STRIDED = K.SCORE_VOLUME_STRIDED
    n_rounds = len(mlog["rounds"])
    n_kf = [len(i) for i in sim.infos]
    log(f"cg_mrslam: {sim.R} robots, {sum(n_kf)} keyframes {n_kf}, "
        f"{n_rounds} exchange rounds in {wall:.2f} s; K1 launches {k1_mr}, "
        f"K2 launches {k2_launches} ({k2_by})")
    log(f"cg_mrslam: solver bands {bands}")
    outs = [outcomes(st) for st in sim.states]
    n_ticks = min(len(t.gt) for t in sim.trajs)
    gap = np.hypot(*(sim.trajs[0].gt[:n_ticks, :2]
                     - sim.trajs[1].gt[:n_ticks, :2]).T)
    log(f"cg_mrslam: robots within the {sim.cfg.mr.sim_comm_range} m comm "
        f"range on {int((gap < sim.cfg.mr.sim_comm_range).sum())} of "
        f"{n_ticks} ticks")
    for r, st in enumerate(sim.states):
        kt = np.asarray(mlog["kf_ticks"][r])
        tr = sim.trajs[r]
        est = own_poses(st)
        assert len(est) == len(kt), (len(est), len(kt))
        a_slam, a_odom = ate(est, tr.gt[kt]), ate(tr.odom[kt], tr.gt[kt])
        e = cross_err(st, sim.states[1 - r])
        log(f"cg_mrslam: robot {r}: {outs[r]}; closures "
            f"{int(sim.closure_stats[r])}; final chi2 "
            f"{sim.infos[r][-1].chi2:.4f}; ATE {a_slam:.4f} m vs odometry "
            f"ATE {a_odom:.4f} m; cross-robot agreement on {len(e)} "
            f"vertices: median {np.median(e) if len(e) else float('nan'):.4f}"
            f" m, max {e.max() if len(e) else float('nan'):.4f} m")
        assert outs[r]["foreign"] > 0, outs
        assert all(np.isfinite(i.chi2) for i in sim.infos[r])
        assert {i.solver_backend for i in sim.infos[r]} == {0}
        assert a_slam < a_odom, (r, a_slam, a_odom)
        assert len(e) > 0 and np.median(e) < MAX_AGREEMENT_M, (r, e)
    for name, ms in times.items():
        clock = ("host clock, synchronized" if name in ("keyframe",
                 "exchange_round") else "CUDA events")
        log(f"cg_mrslam: {name} ({clock}): {percentiles(ms)}, total "
            f"{sum(ms) / 1e3:.2f} s")
    log(f"cg_mrslam: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    condenses = {b: bands.get(("optimize_auto", b), 0)
                 for b in ("chain", "pcg")}
    log(f"cg_mrslam: condenses by band {condenses}")
    assert sum(o["inter_closures"] for o in outs) >= 1, outs
    assert sum(o["star_edges"] for o in outs) >= 1, outs
    assert k2_launches == 4 * sim.R * n_rounds, (k2_launches, n_rounds)
    # every level of the known-cap search is one fused-pair launch
    assert all(k[1] == 2 and len(k) == 7 for k in k2_by), k2_by
    assert probe_launches == 0, "a probe ran on the path"
    assert k1_mr == 3 * sum(n_kf), (k1_mr, n_kf)
    assert sum(condenses.values()) == len(times["build_star"]) > 0
    assert bands.get(("optimize_auto", "dense"), 0) == 2 * sum(n_kf)

    # --- 7. K2 at the path's lattices ---
    assert sorted(capture2.calls) == sorted(STRIDED), sorted(capture2.calls)
    for name, stride in STRIDED.items():
        args = capture2.calls[name]
        dev = args[0].device
        ty = lattice(args[6], stride, dev)
        tx = lattice(args[7], stride, dev)
        rec = check_kernel(K.SCORE_VOLUME_STRIDED, args, ty, tx)
        key = tuple(rec["shape"]) + (stride, stride)
        rec = {"name": f"score_volume_strided[{name}]", "route": "cuda",
               "source": SOURCE, "replaces": REPLACES_K2, "pair": True,
               "launches": k2_by[key],
               "launches_per_round": k2_by[key] / n_rounds,
               "captured_at_round": capture2.keyframe[name],
               "stride": stride, **rec}
        assert k2_by[key] == sim.R * n_rounds, (name, k2_by[key])
        records.append(rec)
        log(kernel_line(rec, ghz) + f" (round {rec['captured_at_round']}, "
            f"{rec['live_volumes']} live volumes, spread "
            f"{rec['spread_dy']:.4g}/{rec['spread_dx']:.4g})")
        for pr in check_probes(args, ty, tx, name):
            probe_records.append(pr)
            log(kernel_line(pr, ghz))
    for pr in probe_records:   # the main paths' counts: 0 by the asserts
        pr["launches"] = 0

    # --- 8. the exchange rounds up to the first inter-robot closure, on
    # the CPU ---
    t0 = time.perf_counter()
    first = next((k for k, (_, o, _) in enumerate(mlog["rounds"])
                  if any(x["inter_closures"] for x in o)), None)
    assert first is not None and first < MAX_CPU_ROUNDS, first
    _, _, clog = run_mr("cpu", max_ticks=mlog["rounds"][first][0] + 1)
    assert len(clog["rounds"]) == first + 1, (len(clog["rounds"]), first)
    for k, ((tc, oc, pc), (tg, og, pg)) in enumerate(
            zip(clog["rounds"], mlog["rounds"])):
        assert tc == tg and oc == og, (k, tc, oc, tg, og)
        for a, b in zip(pc, pg):
            d = a.astype(np.float64) - b
            d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
            assert np.all(np.abs(d) <= 1e-3), (k, np.abs(d).max())
    rounds = [o for _, o, _ in clog["rounds"]]
    assert all(o["foreign"] > 0 for o in rounds[0]), rounds[0]
    # a hypothesis enters a peer buffer only where the global search
    # matched a parked vertex (a vertex is parked and tried in one round)
    assert any(o["hypotheses"] > 0 for r in rounds for o in r), rounds
    assert any(o["inter_closures"] > 0 for o in rounds[-1]), rounds[-1]
    log(f"cpu replay: {first + 1} exchange rounds (ticks "
        f"{clog['rounds'][0][0]}..{clog['rounds'][-1][0]}), up to the first "
        f"inter-robot closure, agree with the card; outcomes "
        f"{rounds[-1]} in {time.perf_counter() - t0:.2f} s")

    # --- 9. the command line ---
    t0 = time.perf_counter()
    phase_cli(cfg, traj, fov, slam, kf_t)
    log(f"cli: phase 9 in {time.perf_counter() - t0:.1f} s")

    # --- 10. the per-process UDP deployment ---
    t0 = time.perf_counter()
    udp = phase_udp(probes)
    for rec in records:
        kernel = (K.SCORE_VOLUME_STRIDED if rec.get("pair")
                  else K.SCORE_VOLUME)
        key = tuple(rec["shape"]) + ((rec["stride"],) * 2 if rec.get("pair")
                                     else ())
        rec["launches_udp_robot0"] = udp[kernel].get(key, 0)
    log(f"udp: phase 10 in {time.perf_counter() - t0:.1f} s")

    # --- 11. the matcher's other modes and the exchange's two options ---
    t0 = time.perf_counter()
    recs, probe_recs = phase_matcher(slam, cfg, matches, sim, mlog, probes,
                                     ghz, udp)
    records += recs
    probe_records += probe_recs
    log(f"matcher: phase 11 in {time.perf_counter() - t0:.1f} s")

    # --- 12. the parallel layer, live ingestion and the viz export ---
    t0 = time.perf_counter()
    assert before["tick"] == mlog["rounds"][first][0], (before["tick"], first)
    phase_parallel(slam, cfg, traj, fov, slam.infos, kf_t, sim, mlog, times,
                   first, before, records)
    log(f"parallel: phase 12 in {time.perf_counter() - t0:.1f} s")

    # --- 13. the JAX bench's workloads on the card ---
    t0 = time.perf_counter()
    k1_1024, hvp_records = phase_bench(matches)
    for rec in records:
        if not rec.get("pair") and "launches_main_path" not in rec:
            rec["launches_srslam_1024"] = k1_1024.get(tuple(rec["shape"]), 0)
    assert len(HVP_STRETCHES) == 6, sorted(HVP_STRETCHES)
    for rec in hvp_records:       # the pair's, the solve's and each
        if "cg_update" in rec["name"]:  # update's, over every shape each
            main = sum(v["cg_update_launches"]           # ran at
                       for v in HVP_STRETCHES.values()) // 2
        else:
            key = "cr_launches" if "cr_apply" in rec["name"] else "launches"
            main = sum(v[key] for v in HVP_STRETCHES.values())
        rec.update(launches_main_path=main,
                   launches_by_stretch=dict(HVP_STRETCHES))
    records += hvp_records
    log(f"bench: phase 13 in {time.perf_counter() - t0:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": records + probe_records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
