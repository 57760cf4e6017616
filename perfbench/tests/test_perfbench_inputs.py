"""The benchmark's frozen inputs and its plain reference, on the CPU."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cg_mrslam_tpu_torch.core.graph import PoseGraph  # noqa: E402
from cg_mrslam_tpu_torch.sim import graphs as program_graphs  # noqa: E402
from cg_mrslam_tpu_torch.solver import gauss_newton as gn  # noqa: E402
from perfbench.gen import hospital  # noqa: E402
from perfbench.reference import gauss_newton as ref  # noqa: E402

MERGED = hospital.DATA / "merged_2robot_1024.npz"
SRSLAM = hospital.DATA / "srslam_hospital_1024.npz"

FIELDS = ("poses", "vmask", "fixed", "e_ij", "e_z", "e_info", "emask",
          "e_level", "e_owner", "n_vertices", "n_edges")


def _host(g: PoseGraph) -> dict:
    return {k: getattr(g, k).numpy() for k in FIELDS}


@pytest.mark.parametrize("seed", [0, 11])
def test_merged_equals_the_program_batch(seed):
    mine, meta = hospital.snapshot(2, MERGED, 1024, 896, seed=seed)
    g, order, pmeta = program_graphs.build_merged_batch(2, seed=seed,
                                                        device="cpu")
    theirs = _host(g)
    for k in FIELDS:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert pmeta == {k: meta[k] for k in pmeta}
    assert (meta["n_vertices"], meta["foreign_vertices"],
            meta["n_edges"], mine["e_ij"].shape[1]) == (1020, 515, 867, 896)


def test_the_snapshot_is_the_program_fixture():
    a = np.load(MERGED)
    b = np.load(ROOT / "tests" / "fixtures" / "merged_2robot_1024.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_srslam_snapshot_fits_its_bucket():
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "hospital_1robot_cap1024.json").read_text())["graph"]
    g, meta = hospital.snapshot(3, SRSLAM, 512, 2048, seed=9)
    assert g["poses"].shape == (3, 512, 3) and g["e_ij"].shape == (3, 2048,
                                                                   2)
    nv, ne = meta["n_vertices"], meta["n_edges"]
    assert (nv, ne) == (cfg["live_vertices"], cfg["live_edges"])
    assert g["vmask"][:, :nv].all() and not g["vmask"][:, nv:].any()
    assert g["emask"][:, :ne].all() and not g["emask"][:, ne:].any()
    assert g["fixed"][0].tolist() == [True] + [False] * 511
    z = np.load(SRSLAM)
    # the noise moves every live free pose, and nothing else
    moved = np.any(g["poses"] != z["poses"][None, :512], axis=2)
    np.testing.assert_array_equal(moved, g["vmask"] & ~g["fixed"])


def test_reference_is_the_program_dense_band_in_float64():
    """Exact GN x5 of the reference and the program's dense band, both in
    float64 on the srslam snapshot, agree to rounding."""
    g, _ = hospital.snapshot(2, SRSLAM, 512, 2048, seed=4)
    g64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in g.items()}
    pg = PoseGraph(**{k: torch.as_tensor(v) for k, v in g64.items()})
    program = gn.optimize_auto(pg, 5, chol=True).poses.numpy()
    mine = ref.optimize(g, 5).numpy()
    assert np.abs(program - mine).max() < 1e-8
    # the dead slots keep their pose
    np.testing.assert_array_equal(mine[:, 512 - 1], g["poses"][:, 512 - 1])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12,
                      -3.0, float("inf")])
    r = ref.round_tf32(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 4 * 2**-11, 1.0, -3.0,
                          float("inf")]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import perfbench.reference.gauss_newton; "
            "import perfbench.gen.hospital; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))"
            ).format(root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = eval(out)
    for name in ("cg_mrslam_tpu_torch", "cg_mrslam_tpu", "jax"):
        assert name not in tops


def test_the_pcg_band_at_its_budget_reaches_the_reference():
    """The program's PCG band at the two-robot configuration's CG budget,
    in float64, ends where the reference's exact GN x5 does, to the CG
    budget's truncation (float32 rounding moves it as far: ~1e-4)."""
    from cg_mrslam_tpu_torch.solver.chain import chain_order

    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "hospital_2robot_cap1024.json").read_text())
    g, meta = hospital.snapshot(1, MERGED, 1024, 896, seed=3)
    g64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in g.items()}
    pg = PoseGraph(**{k: torch.as_tensor(v) for k, v in g64.items()})
    order = chain_order(torch.as_tensor(meta["v_owner"]),
                        torch.as_tensor(meta["v_remote"]),
                        torch.as_tensor(g["vmask"][0]))
    program = gn.optimize_auto(pg, 5, order=order,
                               pcg_iters=cfg["solve"]["pcg_iters"],
                               loop_cap=64).poses.numpy()
    mine = ref.optimize(g, 5).numpy()
    live = g["vmask"][0]
    assert np.abs(program - mine)[:, live].max() < 2e-4
