"""Count the torch operations that one condense issues in the port.

    python tools/count_torch_ops.py --ticks 120
    python tools/count_torch_ops.py --chain 1024

Runs the two-robot ``cg_mrslam`` default deployment (``chip_smoke.py``'s
``deployment_config``) through ``MultiRobotSim`` on the CPU up to ``--ticks``,
then counts, with a dispatch-mode counter, the operations of one
``build_star`` of robot 0 for robot 1 and of the solver pieces inside it.
On the card each operation is at least one host dispatch and most are one
kernel launch, so the count says how host-bound a condense is. The CPU's
times are printed for orientation only; they are not the card's.

With ``--chain N``: the operations of the chain band's two solver calls in
a keyframe above the dense band, on one ``N``-pose hospital graph
(``sim/graphs.build_hospital_batch``): ``optimize_chain`` at
``optimize_auto``'s budget (5 GN iterations, 48 CG, tolerance 1e-6) and
``marginal_covariance_chain`` of 8 vertices at
``marginal_covariance_auto``'s (64 CG, 1e-5).
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import deployment_config  # noqa: E402
from cg_mrslam_tpu_torch.mr import mrslam as MR  # noqa: E402
from cg_mrslam_tpu_torch.mr.sim import MultiRobotSim  # noqa: E402
from cg_mrslam_tpu_torch.sim import world as W  # noqa: E402
from cg_mrslam_tpu_torch.solver import chain as CH  # noqa: E402
from cg_mrslam_tpu_torch.solver import gauss_newton as gn  # noqa: E402
from cg_mrslam_tpu_torch.solver import pcg as PCG  # noqa: E402

# (module whose global is looked up at the call, name): pcg.py and chain.py
# import the cyclic reduction (solver/cyclic_reduction.py), the SPD
# inverse and the CG loop's updates (ops/cg_update.py) by name;
# chain.cr_apply is the Woodbury set-up's Hc⁻¹U solve
PIECES = [(CH, "cr_factor"), (CH, "cr_apply"), (CH, "cr_apply_cols"),
          (CH, "spd_inverse"), (CH, "_h_matvec"), (CH, "_precond"),
          (PCG, "cr_factor"), (PCG, "cr_apply_cols"), (PCG, "_hvp"),
          (PCG, "cg_update_a"), (PCG, "cg_update_b")]


class Count(TorchDispatchMode):
    """Counts every operation dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def counted(fn, ops, calls, name):
    def call(*a, **k):
        c = Count()
        with c:
            out = fn(*a, **k)
        ops[name] += c.n
        calls[name] += 1
        return out
    return call


def chain_ops(n: int) -> int:
    from cg_mrslam_tpu_torch.sim.graphs import build_hospital_batch

    gb = build_hospital_batch(1, n=n, device="cpu")
    g = gn._take(gb, 0)
    for name, fn in (
            ("optimize_chain (5 GN, cg 48, tol 1e-6)",
             lambda: CH.optimize_chain(g, 5, loop_cap=64, cg_iters=48,
                                       cg_tol=1e-6)),
            ("marginal_covariance_chain (8 vertices, cg 64, tol 1e-5)",
             lambda: CH.marginal_covariance_chain(
                 g, torch.arange(0, n, n // 8), loop_cap=64, cg_iters=64,
                 cg_tol=1e-5))):
        c = Count()
        with c:
            fn()
        print(f"{name} at {n} poses: {c.n} operations")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--chain", type=int, default=None, metavar="N")
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    if a.chain:
        return chain_ops(a.chain)
    sim = MultiRobotSim(deployment_config(2),
                        W.hospital_world(40.0, 20.0, seed=0), beams=360,
                        max_range=10.0, seed=0, n_loops=2,
                        odom_noise=(0.01, 0.004), width=40.0, height=20.0,
                        device="cpu")
    sim.run(max_ticks=a.ticks)
    st = sim.states[0]
    g = st.slam.graph
    em = g.emask.numpy()
    vo = st.slam.v_owner.numpy()
    ij = g.e_ij.numpy()[em]
    inter = int((vo[ij[:, 0]] != vo[ij[:, 1]]).sum())
    print(f"tick {a.ticks}: robot 0 holds {int(g.n_vertices)} vertices, "
          f"{inter} edges between robots")

    ops, calls = collections.Counter(), collections.Counter()
    for mod, name in PIECES:
        setattr(mod, name, counted(getattr(mod, name), ops, calls,
                                   f"{mod.__name__.rsplit('.', 1)[1]}."
                                   f"{name}"))
    gn.BAND_CALLS.clear()
    total = Count()
    t0 = time.perf_counter()
    with total:
        MR.build_star(st, 1, cap=sim.cfg.mr.star_edges_cap)
    print(f"build_star: {total.n} operations, bands {dict(gn.BAND_CALLS)}, "
          f"{time.perf_counter() - t0:.2f} s on the CPU")
    for name in ops:
        print(f"  {name}: {calls[name]} calls, {ops[name]} operations "
              f"({ops[name] / calls[name]:.0f} a call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
