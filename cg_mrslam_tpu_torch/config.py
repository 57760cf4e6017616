"""One typed config holding every behavioural constant of the system.

A copy of ``cg_mrslam_tpu/config.py``: the two packages are built from the
same keyword arguments, so a config crosses between them by value.

The reference scatters these across CLI defaults
(reference ``src/cg_mrslam.cpp:69-117``), hard-coded matcher internals
(``graph_slam.cpp:58-76``, ``scan_matcher.cpp:34-36,148-151,230-246,384-391,
499``), candidate-selection thresholds (``vertices_finder.h:97-99``), gating
constants (``graph_slam.cpp:233,329-351,399``; ``mr_graph_slam.cpp:175,261``)
and comm constants (``graph_comm.h:48-49``, ``graph_comm.cpp:152``,
``msg_factory.h:115``). They define behaviour parity, so they all live here.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Correlative scan matcher parameters (one per grid instance)."""

    extent: float = 30.0          # grid side length [m] (closeMatcher 30×30,
    #                               LCMatcher 70×70 — graph_slam.cpp:58-62)
    resolution: float = 0.025     # cell size [m] (CLI -resolution)
    kernel_radius: float = 0.2    # distance cap [m]: closeMatcher uses the
    #                               CLI kernelRadius (0.2), LCMatcher is
    #                               hard-coded 0.5 (graph_slam.cpp:59-61).
    #                               Grid values are meters capped here (the
    #                               reference's kscale=128 byte quantisation
    #                               is not reproduced).
    max_score: float = 0.15       # acceptance threshold: mean distance [m]
    #                               (CLI -maxScore, chargrid.cpp:275-280)

    @property
    def cells(self) -> int:
        return int(round(self.extent / self.resolution))


@dataclasses.dataclass(frozen=True)
class SearchWindows:
    """Search-region geometry of the three matching modes
    (scan_matcher.cpp:148-151, :222-246, :384-391)."""

    # (a) close matching — odometry refinement
    close_dx: float = 0.3
    close_dy: float = 0.3
    close_dth: float = 0.2
    close_th_res: float = 0.00625
    # motion-prior weight (score units per meter/radian of deviation from
    # the odometry guess) — MAP fusion of match likelihood with odometry;
    # see matcher/search.py. The reference has no equivalent (its 1081-beam
    # scans drown occlusion noise); required for sparse-beam robustness.
    close_prior_weight: float = 0.15
    # (b) loop-closure matching — per candidate vertex (+π-rotated twins)
    lc_dx: float = 0.5
    lc_dy: float = 1.5
    lc_dth: float = 0.8
    lc_th_res: float = 0.025
    lc_merge_dx: float = 0.5     # result dedup lattice (scan_matcher.cpp:246)
    lc_merge_dy: float = 0.5
    lc_merge_dth: float = 0.2
    # (c) global matching — inter-robot, unknown relative pose
    global_dx: float = 10.0
    global_dy: float = 5.0
    global_th_res: float = 0.025  # finest θ step of hierarchical search
    global_levels: int = 4        # coarse-to-fine steps ×8,×4,×2,×1
    # θ trust window around the TRANSMITTED estimate of the foreign
    # vertex. The reference searches full θ (globalMatching lower/upper
    # ±M_PI, scan_matcher.cpp:386-388) while trusting the transmitted
    # POSITION to ±(10,5) m — but its deployments share one map frame
    # (per-robot initial poses are configured in a common frame,
    # README.md:77-93), so the transmitted θ deserves the same trust.
    # Full-θ search in a self-similar corridor accepts π-rotated twin
    # matches that are mutually consistent and sail through the closure
    # vote (measured: ATE 1.8 m from exactly this). 1.3 rad (74°) is
    # generous against inter-map θ drift while excluding the ±π/2
    # wall-direction symmetries of man-made interiors (a ±π/2 window
    # re-admits exact quarter-turn aliases at its endpoints — measured).
    # π restores the reference behavior.
    global_th_span: float = 1.3
    # coarse-level survivors of the hierarchical search. 16 loses the
    # true basin in aliased corridors (the top-16 coarse cells are all
    # corridor-slide twins of each other); 48 keeps it at negligible
    # refine cost (tiny vmapped windows).
    global_branch: int = 48
    # verifyMatching acceptance: box-mean of the unmatched-point distance
    # grid ≤ threshold/kscale meters (scan_matcher.cpp:493-502; kscale=128)
    verify_threshold: float = 40.0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Single-robot SLAM engine parameters (GraphSLAM semantics)."""

    # keyframe gating (cg_mrslam.cpp:78-79, :216-217)
    linear_update: float = 0.25
    angular_update: float = math.pi / 4
    # vertex id namespacing (cg_mrslam.cpp:159-160, graph_slam.cpp:155)
    base_id: int = 10000
    # odometry vs scan-match edge information (graph_slam.cpp:72-76)
    odom_info: tuple = (100.0, 100.0, 1000.0)       # diag
    sm_info: tuple = (1000.0, 1000.0, 10000.0)      # diag
    # close-matching looks at the previous ≤5 vertices (graph_slam.cpp:233)
    close_match_window: int = 5
    # Mahalanobis gate for closure candidates (graph_slam.cpp:329-351)
    chi2_gate: float = 5.99
    perception_range_deflate: float = 1.0
    # candidate selection (vertices_finder.h:97-99)
    max_graph_dist_sm: float = 2.0
    min_graph_dist_lc: float = 5.0
    max_euc_dist_lc: float = 50.0
    # windowed closure vote (CLI defaults)
    window_loop_closure: int = 10
    min_inliers: int = 7
    inlier_threshold: float = 2.0
    # candidate components are widened by vertices within ±gap ids of a
    # member before matching (addNeighboringVertices, graph_slam.cpp:399)
    neighbor_gap: int = 8
    # own vertices within this id gap of the current one get a DIRECT
    # close-match edge; larger gaps (or foreign vertices) go through the
    # windowed loop-closure vote (graph_slam.cpp:416)
    direct_id_gap: int = 10
    # optimization budget per keyframe (cg_mrslam.cpp:225, graph_slam.cpp:392)
    gn_iterations: int = 5
    pre_optimize_iterations: int = 1
    # chain-band CG budgets for the LIVE engine (capacity > DENSE_MAX).
    # The solver API defaults stay conservative (cg48/t1e-6, marginals
    # cg64/t1e-5); the engine opts into the committed operating point of
    # the round-3 chip sweep (cg24/t1e-4 — fastest AND most accurate
    # measured on the hospital workload, see bench.py CHAIN_KW) and a
    # cruder budget for the covariance GATE only: the χ²(2) 5.99 cut
    # tolerates ~5% covariance error, and gate marginals are the only
    # O(cg·CR-apply) stage whose output feeds a threshold, not the map.
    chain_cg_iters: int = 24
    chain_cg_tol: float = 1e-4
    gate_cg_iters: int = 16
    gate_cg_tol: float = 1e-3
    # PCG-band budgets (non-chainable graphs past DENSE_MAX — e.g. once
    # live loop closures exceed loop_cap). PCG scans run their FULL
    # static budget (no tolerance exit), so these directly set the
    # per-keyframe cost: the merged-fixture sweep measured cg8 within
    # 0.4% of the dense oracle for solves (artifacts/
    # chain_sweep_merged.json); marginals need deeper budgets (unit
    # columns propagate the whole chain) but the gate only needs ~10%.
    pcg_cg_iters: int = 24
    gate_pcg_iters: int = 96
    # chain-band Woodbury loop capacity for the LIVE engine. The solver
    # default (64) is tuned for batched throughput; live single-robot
    # graphs accumulate real loop closures past 64 within ~600
    # keyframes (measured: run_srslam4096 backend flipped to fixed-
    # budget PCG at kf ~520), and the chain path's tolerance-exit CG +
    # loop-aware preconditioner is much cheaper in the incremental
    # steady state than full-budget PCG. 192 keeps ~1000-keyframe runs
    # chainable; capacitance stays [3·192]² — cheap at batch 1.
    loop_cap: int = 192


@dataclasses.dataclass(frozen=True)
class MRConfig:
    """Multi-robot protocol parameters."""

    n_robots: int = 2
    # inter-robot matcher + vote (CLI -maxScoreMR/-minInliersMR/-windowMR…)
    max_score_mr: float = 0.15
    min_inliers_mr: int = 5
    window_mr_loop_closure: int = 10
    # inter-robot closure edge information (mr_graph_slam.cpp:228-242)
    closure_info: tuple = (100.0, 100.0, 1000.0)
    # combo message carries last ≤5 poses (mr_graph_slam.cpp:564-605)
    combo_poses: int = 5
    # parked foreign vertices retried each keyframe with gap 20
    # (mr_graph_slam.cpp:254-329)
    inter_robot_gap: int = 20
    # global-match coverage gate: score candidates on KNOWN map cells
    # only (distance-field value below the saturation kernel_radius) and
    # require this fraction of scan points on known cells. The raw
    # reference score treats unmapped frontier like far-from-everything
    # (same saturated value), so the TRUE rendezvous pose — which always
    # overhangs the local map's edge — scores worse than an aliased pose
    # buried in covered territory (measured: true 0.26 rejected vs π-twin
    # 0.06 accepted). 0 disables the gate (reference scoring). 0.55:
    # measured true rendezvous poses keep ≥0.62 of their points on known
    # cells while surviving corridor-slide aliases kept 0.33-0.56.
    global_min_known: float = 0.55
    # global matching window: ±10 vertices around reference (21 total,
    # mr_graph_slam.cpp:172-213)
    global_match_window: int = 10
    # visibility gate: require the peer's body to be visible in my scan
    # at the claimed pose before accepting an inter-robot match
    # (verifyMatching; off by default like mr_graph_slam.cpp:46)
    detect_robot_in_range: bool = False
    # connectivity model (graph_comm.h:48-49, graph_comm.cpp:70-101)
    sim_comm_range: float = 5.0
    ping_timeout: float = 10.0
    send_period: float = 0.15      # sender thread cadence (graph_comm.cpp:152)
    max_datagram: int = 100_000    # msg_factory.h:115
    # wire message capacities (static shapes; the reference's messages are
    # variable-length). Overflow is COUNTED (ClosureList.dropped /
    # StarMsg.dropped → Recorder), never silent — and the closure list
    # additionally ROTATES its cap-window across sends (build_closure_list
    # off= + union receive), so an overflowing accepted set is still fully
    # covered over successive 150 ms rounds. 128 boundary edges ≈ 5.3 kB
    # on the wire (2×int32 + 9×float32 each, msg_factory.cpp:163-199) —
    # far inside the 100 kB datagram bound; round-4's cap of 16 bound
    # hard in real runs (54-63 accepted closures → systematic truncation).
    closure_list_cap: int = 128    # boundary vertices per condensed request
    star_edges_cap: int = 128      # virtual edges per star


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Occupancy grid parameters (cg_mrslam.cpp:109-117). Every field is
    consumed by ``maps.occupancy.integrate``/``threshold`` via the CLI
    (``cli._save_outputs``)."""

    resolution: float = 0.05
    occupied_threshold: float = 0.65
    free_threshold: float = 0.196
    gain: float = 3.0
    square_size: int = 0          # endpoint splat half-width (cells)
    angle: float = math.pi / 2    # base transform (graph2occupancy.cpp:52)
    usable_range: float = -1.0    # <0 → use sensor max range
    # invalid/max-range beams trace free space to this range; the
    # reference's live runs hardcode 5.0 after init (cg_mrslam.cpp:134)
    infinity_filling_range: float = 5.0
    # robot-footprint miss splat half-width (fillRobotPose sizeRobot=4,
    # frequency_map.cpp:94); <0 disables
    robot_fill: int = 4


@dataclasses.dataclass(frozen=True)
class Config:
    slam: SlamConfig = dataclasses.field(default_factory=SlamConfig)
    mr: MRConfig = dataclasses.field(default_factory=MRConfig)
    windows: SearchWindows = dataclasses.field(default_factory=SearchWindows)
    close_matcher: MatcherConfig = dataclasses.field(
        default_factory=lambda: MatcherConfig(extent=30.0, resolution=0.025)
    )
    lc_matcher: MatcherConfig = dataclasses.field(
        default_factory=lambda: MatcherConfig(
            extent=70.0, resolution=0.1, kernel_radius=0.5
        )
    )
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    # static array capacities (fixed shapes: the state never reallocates)
    max_vertices: int = 1024
    max_edges: int = 4096
    max_beams: int = 1024
    # fused-step capacities (overflow beyond them is COUNTED in StepInfo/
    # Recorder — no silent truncation; the reference visits all components)
    max_regions: int = 4        # simultaneous loop-closure components
    region_vertices: int = 16   # scans rasterized into one region's grid


DEFAULT = Config()
