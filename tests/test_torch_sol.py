"""``utils/sol.py`` and ``utils/metrics.speed_of_light`` of the port against
the JAX package's, on the same numbers, and the report at small sizes on
the CPU.

* ``account``: the same arithmetic, the units mapped (``mxu_f32`` →
  ``fp32_matmul``, ``mxu_bf16`` → ``bf16_tc``, ``vpu`` →
  ``fp32_cuda_core``). The reference subtracts its dispatch floor and the
  port does not, so the reference is given a floor of 0. Exact: both round
  the same float64 numbers.
* ``speed_of_light``: the reference's function given the port's H100 SXM
  peaks (its table patched in this process only); float64 arithmetic,
  equal to 1e-12 relative.
* ``report(device="cpu")``: every number of every row finite, every
  ceiling and time positive, every rate and fraction at least 0 (they
  are rounded to the reference's 1e-3, and host times at toy sizes can
  round them to 0; no device metric).
"""

import math

import pytest

from cg_mrslam_tpu.utils import metrics as JM
from cg_mrslam_tpu.utils import sol as JSOL
from cg_mrslam_tpu_torch.utils import metrics as TM
from cg_mrslam_tpu_torch.utils import sol as TSOL

UNIT = {"fp32_matmul": "mxu_f32", "bf16_tc": "mxu_bf16",
        "fp32_cuda_core": "vpu"}
CASES = [("K1", 0.015e-3, 7.1e6, 5.2e8, "fp32_cuda_core"),
         ("GN", 0.12, 7.5e9, 1.1e11, "fp32_matmul"),
         ("bf16", 2.0e-3, 1.0e9, 8.0e11, "bf16_tc"),
         ("tiny", 0.0, 1.0, 1.0, "fp32_matmul")]


def _ceilings():
    port = TSOL.Ceilings(hbm_gbps=3010.5, bf16_tc_tflops=702.3,
                         fp32_matmul_tflops=51.7, fp32_cuda_core_tflops=67.0,
                         dispatch_s=2.1e-5)
    ref = JSOL.Ceilings(hbm_gbps=port.hbm_gbps,
                        mxu_bf16_tflops=port.bf16_tc_tflops,
                        mxu_f32_tflops=port.fp32_matmul_tflops,
                        vpu_f32_tflops=port.fp32_cuda_core_tflops,
                        dispatch_s=0.0)
    return port, ref


@pytest.mark.parametrize("name,secs,nbytes,flops,unit", CASES)
def test_account_matches_reference(name, secs, nbytes, flops, unit):
    port, ref = _ceilings()
    got = TSOL.account(name, secs, nbytes, flops, port, unit=unit)
    want = JSOL.account(name, secs, nbytes, flops, ref, unit=UNIT[unit])
    want[f"of_{unit}_peak"] = want.pop(f"of_{UNIT[unit]}_peak")
    assert got == want


@pytest.mark.parametrize("chip", sorted(TM.CHIP_PEAKS))
@pytest.mark.parametrize("flops,nbytes,secs", [(1.1e11, 7.5e9, 0.12),
                                               (5.2e8, 7.1e6, 1.5e-5),
                                               (1.0, 1.0, 0.0)])
def test_speed_of_light_matches_reference(monkeypatch, chip, flops, nbytes,
                                          secs):
    monkeypatch.setitem(JM.CHIP_PEAKS, chip, dict(TM.CHIP_PEAKS[chip]))
    got = TM.speed_of_light(flops, nbytes, secs, chip=chip)
    want = JM.speed_of_light(flops, nbytes, secs, chip=chip)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], str):
            assert got[k] == want[k], k
        else:
            assert math.isclose(got[k], want[k], rel_tol=1e-12), k


def test_peaks_table_is_the_cards():
    assert set(TM.CHIP_PEAKS) == {"h100_sxm", "h100_sxm_tf32",
                                  "h100_sxm_bf16"}
    assert TM.CHIP_PEAKS["h100_sxm"] == {"flops": 67e12, "hbm_gbs": 3.35e12}
    assert "published" in TM.PEAKS_SOURCE


def test_report_on_cpu_at_small_sizes():
    rows = TSOL.report(device="cpu", gn_batch=2, chain_batch=2, chain_n=64,
                       k1_points=128, hbm_mb=4, mm_n=128, reps=2)
    assert len(rows) == 4
    ceil = rows[0]
    for k in ("hbm_gbps", "bf16_tc_tflops", "fp32_matmul_tflops",
              "fp32_cuda_core_tflops", "dispatch_s"):
        assert math.isfinite(ceil[k]) and ceil[k] > 0, k
    assert ceil["device"].startswith("cpu")
    for row in rows[1:]:
        assert row["device"].startswith("cpu") and "device_ms" not in row
        nums = {k: v for k, v in row.items() if isinstance(v, float)}
        assert {"host_ms", "of_hbm_peak", "sol_fraction"} <= nums.keys()
        for k, v in nums.items():
            assert math.isfinite(v) and v >= 0, (row["kernel"], k, v)
        assert row["host_ms"] > 0, row
