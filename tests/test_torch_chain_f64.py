"""The chain band over a batch against the JAX package's ``vmap``, in
float64, pose by pose, on two of ``bench.py``'s hospital graphs (N = 1024;
vertex 0 fixed, so no gauge is free).

In float64 both packages take the same path through these solves, so the
poses agree to rounding (measured 1e-14 to 1.4e-9) and the bar is 1e-6 m
and rad. Four solves:

* one GN iteration at ``bench.py``'s ``CHAIN_KW`` (48 loop closures);
* five iterations with ``cg_schedule`` (48, 24, 16, 12, 12) (48 closures);
* five iterations at ``CHAIN_KW`` with ``freeze_precond`` (48 closures);
* five iterations at ``CHAIN_KW`` on the graphs with 12 closures.

Checked against broken copies of the port: the last GN iteration left out
fails all three; the linearization in float32 fails all three; half the
CG budget fails the two five-iteration solves (the first iteration's CG
stops on its tolerance before that budget); the GN step rounded to
float32 fails the schedule's.

Five iterations at ``CHAIN_KW`` on the 48-closure graphs are not compared
here. The Newton–Schulz
polish of the capacitance inverse (condition ~1.8e5 on these graphs) can
read a residual that grew as divergence and restart from its seed, then
end far from the inverse; whether it does turns on the last bits of the
matrix. That is the reference's own algorithm: given the port's float64
capacitance matrices of four bench graphs, the reference's
``spd_inverse`` ends at ‖I − SX‖ of 51 and 63 on two of them and the
port's at 63 on a third (1e-9 elsewhere). It sends a graph down another
path: graph 1 ends 3.1e-3 apart after five iterations, and bench graph 2
is 0.37 apart after one. Those five iterations are held in float32,
against the reference and against the exact optimum, by
``tests/test_torch_batched.py``. With 12 closures the capacitance matrix
is small and well conditioned, its inverse converges on every graph
(‖I − SX‖ ~1e-13 on eight), and five iterations agree throughout.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
from cg_mrslam_tpu.solver import chain as JCH  # noqa: E402
from cg_mrslam_tpu_torch.sim import graphs as TGR  # noqa: E402
from cg_mrslam_tpu_torch.solver import chain as TCH  # noqa: E402
from torch_port_helpers import npy  # noqa: E402

torch.set_num_threads(1)

POSE_F64 = 1e-6
SOLVES = {
    "one_iteration": (48, 1, dict(bench.CHAIN_KW)),
    "cg_schedule": (48, 5, dict(cg_schedule=(48, 24, 16, 12, 12),
                                cg_tol=1e-4, loop_cap=64)),
    "freeze_precond": (48, 5, dict(bench.CHAIN_KW, freeze_precond=True)),
    "five_iterations_12_closures": (12, 5, dict(bench.CHAIN_KW)),
}


def _f64_pair(closures):
    jg = bench.build_hospital_batch(2, closures=closures)
    jg = dataclasses.replace(jg, **{f: getattr(jg, f).astype(jnp.float64)
                                    for f in ("poses", "e_z", "e_info")})
    tg = TGR.build_hospital_batch(2, closures=closures, device="cpu")
    tg = dataclasses.replace(tg, **{f: getattr(tg, f).double()
                                    for f in ("poses", "e_z", "e_info")})
    return jg, tg


@pytest.fixture(scope="module")
def hospital64():
    return {c: _f64_pair(c) for c in (48, 12)}


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_chain_float64_poses_match_vmap(hospital64, solve):
    closures, iters, kw = SOLVES[solve]
    jg, tg = hospital64[closures]
    want = jax.vmap(lambda g: JCH.optimize_chain(g, iterations=iters,
                                                 **kw))(jg).poses
    got = TCH.optimize_chain(tg, iters, **kw).poses
    assert got.dtype == torch.float64
    d = npy(got) - np.asarray(want)
    d[..., 2] = (d[..., 2] + np.pi) % (2 * np.pi) - np.pi
    err = np.abs(d).reshape(2, -1).max(-1)
    assert np.all(err <= POSE_F64), err
