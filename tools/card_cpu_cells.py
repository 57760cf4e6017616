"""Where the card's float32 arithmetic departs from the CPU's, and whether a
version of the package puts points in the same grid cells on both.

    python3 tools/card_cpu_cells.py [--root DIR]

Prints, on one GPU: (1) the share of 4,000,000 random float32 values for
which the card's ``sin``, ``cos`` and division by a Python number (the grid
resolutions 0.1 and 0.025) differ from the CPU's, and the same for
``se2.cos_sin`` (rounded from float64) and for a division by a device
tensor; (2) with the package under ``--root`` (default: this checkout; e.g.
an earlier commit unpacked with ``git archive <commit> cg_mrslam_tpu_torch |
tar -x -C build/prev_tree``), how many of the card test's edge points
(``tests/test_torch_cuda.py:_straddling``) land in another cell on the
card than on the CPU through ``world_to_cell`` and ``volume_cells``.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def share(a: torch.Tensor, b: torch.Tensor) -> str:
    n = int((a.cpu() != b.cpu()).sum())
    return f"{n} of {a.numel()} ({100.0 * n / a.numel():.1f}%)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(a.root))
    import cg_mrslam_tpu_torch
    from cg_mrslam_tpu_torch.matcher.grid import world_to_cell
    from cg_mrslam_tpu_torch.ops import correlate as K

    print(f"{torch.cuda.get_device_name(0)}; package "
          f"{os.path.dirname(cg_mrslam_tpu_torch.__file__)}")
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(4_000_000, generator=gen) * 8 - 4
    for name, f in (("sin", torch.sin), ("cos", torch.cos)):
        rounded = f(x.double()).float()
        print(f"float32 {name}: card differs from the CPU for "
              f"{share(f(x.cuda()), f(x))}; rounded from float64: "
              f"{share(f(x.double().cuda()).float(), rounded)}")
    y = torch.rand(4_000_000, generator=gen) * 60 - 30
    for res in (0.1, 0.025):
        dev_res = torch.full((), res, device="cuda")
        print(f"float32 division by {res}: by a Python number the card "
              f"differs from the CPU for {share(y.cuda() / res, y / res)}; "
              f"by a device tensor {share(y.cuda() / dev_res, y / res)}")

    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    for res, cells in ((0.1, 700), (0.025, 1200)):
        e = tests._straddling(res, cells)
        pts = torch.as_tensor(np.stack([e, e[::-1]], 1))
        zero = torch.zeros(2)
        wc = (world_to_cell(pts.cuda(), zero.cuda(), cells, res).cpu()
              != world_to_cell(pts, zero, cells, res)).any(1)
        n = len(e)
        args = (torch.zeros(1, 2), res, cells, pts,
                torch.ones(1, n, dtype=torch.bool), torch.zeros(1, 3),
                torch.zeros(1))
        want = K.volume_cells(*args)
        got = K.volume_cells(*(t.cuda() if torch.is_tensor(t) else t
                               for t in args))
        vc = ((got[0].cpu() != want[0]) | (got[1].cpu() != want[1])).any(1)
        print(f"edge points at {res} m, {cells} cells: {n}; in another cell "
              f"on the card: world_to_cell {int(wc.sum())}, volume_cells "
              f"{int(vc.sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
