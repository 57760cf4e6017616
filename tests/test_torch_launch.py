"""``parallel.launch.run_group``: a group whose rank fails, or that outlives
its timeout, is killed and the call raises at once with the ranks'
tracebacks, instead of waiting for peers blocked in a collective."""

import time

import pytest
import torch

from cg_mrslam_tpu_torch.parallel.launch import run_group
import torch_dist_workers as workers

torch.set_num_threads(1)


def test_run_group_raises_when_a_rank_fails(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose") as err:
        run_group(workers.fail_on_last, 2, workdir=tmp_path, timeout=110.0)
    assert "ranks [1] failed" in str(err.value)
    # rank 0 is still in its barrier: the call must not wait for the timeout
    assert time.monotonic() - t0 < 60.0


def test_run_group_kills_a_group_past_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"still running after 20.0 s"):
        run_group(workers.sleep_on_last, 2, args=(600.0,), workdir=tmp_path,
                  timeout=20.0)
    assert time.monotonic() - t0 < 60.0
