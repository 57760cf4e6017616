"""Time the score-volume kernels K1 and K2 at the main path's shapes on one
GPU, against another version of the same source, in one process.

    python3 tools/bench_score_volume.py [--prev build/prev/score_volume.cu]
                                        [--out chiprun_out/bench_score_volume.json]

Builds ``csrc/score_volume.cu`` and, when ``--prev`` names a file, that
earlier version of it (nothing of it is committed: copy it into the
ignored ``build/`` first, e.g. ``git show <commit>:cg_mrslam_tpu_torch/
csrc/score_volume.cu > build/prev/score_volume.cu``), and prints each one's
``ptxas -v`` report. Then, at every main-path shape (K1: close, near, loop;
K2: level 0 and the refine levels at strides 4, 2, 1, all as the
``known_cap`` pair), on synthetic inputs made from a seed (a 360-beam scan
of 1-9.5 m ranges over 270 degrees, grids built from 3000 random wall
points), it:

* checks every version against the plain version (rtol 1e-5, atol
  1e-6);
* times each version's launch (:func:`raw_launcher`: no input check, no
  count) as ``device_ms`` (CUDA graph replay, device time only) in turns —
  previous, current, current, previous — and ``event_ms`` / ``host_us``
  (events around back-to-back launches; host clock per launch), and the
  current wrapper's ``host_us`` (input checks and count included);
* times the two probes of the current source (``no_gather``,
  ``const_cells``, through their wrappers) by ``device_ms``;
* computes the bytes bound and the gather design's issue floor at the
  card's maximum SM clock (``issue_floor_ms_at_max_clock``: computed, not
  measured).

A version without the fused pair scores a pair shape as the earlier path
did (two grids, every search repeated). Prints one JSON line per shape
and writes them all, with the card's name and power limit and the sha1 of
each source timed, to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cg_mrslam_tpu_torch.matcher.grid import build_grids  # noqa: E402
from cg_mrslam_tpu_torch.ops import correlate as K  # noqa: E402
from cg_mrslam_tpu_torch.utils import cuda_timing as CT  # noqa: E402

# name -> (B, T, ny, nx, stride, cells, resolution, grids, known_cap pair)
SHAPES = {
    "close": (1, 65, 12, 12, 1, 1200, 0.025, 1, False),
    "near": (4, 17, 3, 3, 1, 700, 0.1, 4, False),
    "loop": (8, 65, 15, 5, 1, 700, 0.1, 4, False),
    "level0": (1, 13, 6, 12, 8, 700, 0.1, 1, True),
    "refine4": (48, 5, 2, 2, 4, 700, 0.1, 1, True),
    "refine2": (48, 5, 2, 2, 2, 700, 0.1, 1, True),
    "refine1": (48, 5, 2, 2, 1, 700, 0.1, 1, True),
}
KNOWN_CAP = 0.5 * 0.999   # the LC grid's kernel radius, as mr/mrslam.py sets
RTOL, ATOL = 1e-5, 1e-6


def raw_launcher(lib, args):
    """A callable that launches ``lib``'s kernel on a wrapper's arguments —
    K1's ``(grids, gidx, ix, iy, keep, count, ry, rx)`` or K2's ``(...,
    ny, nx, sy, sx, known_cap)`` — with no check and no count, for any
    version of the source. A version without the fused pair scores a pair
    as the earlier path did: one strided launch over the two grids of
    :func:`correlate.stack_pair`."""
    b, t = args[2].shape[:2]
    if len(args) == 8:
        ry, rx = args[6:]
        return lambda: K.launch(lib.cg_score_volume, *args[:6],
                                (b, t, 2 * ry + 1, 2 * rx + 1), ry, rx)
    ny, nx, sy, sx, cap = args[6:]
    dy, dx = 2 * ny + 1, 2 * nx + 1
    if cap is None:
        return lambda: K.launch(lib.cg_score_volume_strided, *args[:6],
                                (b, t, dy, dx), ny, nx, sy, sx)
    if hasattr(lib, "cg_score_volume_pair"):
        return lambda: K.launch(lib.cg_score_volume_pair, *args[:6],
                                (b, 2, t, dy, dx), ny, nx, sy, sx, cap)
    two = K.stack_pair(*args[:6], cap)
    return lambda: K.launch(lib.cg_score_volume_strided, *two,
                            (2 * b, t, dy, dx), ny, nx, sy,
                            sx).reshape(b, 2, t, dy, dx)


def make_inputs(dev, bsz, t, cells, res, n_grids, seed=0):
    rng = np.random.default_rng(seed)
    half = cells * res / 2
    walls = torch.as_tensor(rng.uniform(-half * 0.8, half * 0.8,
                                        (n_grids, 3000, 2)),
                            dtype=torch.float32, device=dev)
    grids = build_grids(walls, torch.ones(n_grids, 3000, dtype=torch.bool,
                                          device=dev),
                        torch.zeros(n_grids, 2, device=dev), cells=cells,
                        resolution=res, kernel_radius=0.5)
    ang = np.linspace(-0.75 * np.pi, 0.75 * np.pi, 360)
    rng_m = rng.uniform(1.0, 9.5, 360)
    pts = torch.as_tensor(np.stack([rng_m * np.cos(ang),
                                    rng_m * np.sin(ang)], -1),
                          dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.uniform(size=(bsz, 360)) > 0.05, device=dev)
    bases = torch.as_tensor(np.concatenate(
        [rng.uniform(-2, 2, (bsz, 2)), rng.uniform(-np.pi, np.pi, (bsz, 1))],
        1), dtype=torch.float32, device=dev)
    gidx = (torch.arange(bsz, device=dev) % n_grids).to(torch.int32)
    thetas = torch.linspace(-0.4, 0.4, t, device=dev)
    cells_ = K.volume_cells(torch.zeros(bsz, 2, device=dev), res, cells, pts,
                            valid, bases, thetas)
    return grids, gidx, cells_


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prev", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "bench_score_volume.json")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_score_volume: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = CT.card_line()
    ghz = CT.max_sm_clock_ghz()
    print(card, f"max SM clock {ghz:.3f} GHz", flush=True)
    srcs = {"current": K._SRC}
    if a.prev is not None:
        srcs["prev"] = a.prev
    libs = {k: K.load_library(src) for k, src in srcs.items()}
    sha1 = {k: hashlib.sha1(Path(src).read_bytes()).hexdigest()
            for k, src in srcs.items()}
    for name, src in srcs.items():
        print(f"--- ptxas ({name}: {src}, sha1 {sha1[name]})\n"
              f"{K.ptxas_report(src)}", flush=True)
    dev = torch.device("cuda")
    rows = []
    for name, (b, t, ny, nx, s, cells, res, ng, pair) in SHAPES.items():
        grids, gidx, cells_ = make_inputs(dev, b, t, cells, res, ng)
        base = (grids, gidx) + tuple(cells_)
        # the wrappers' arguments: K1 (ry, rx), K2 (ny, nx, sy, sx, cap)
        args = base + ((ny, nx) if s == 1 and not pair else
                       (ny, nx, s, s, KNOWN_CAP if pair else None))
        ty = torch.arange(-ny, ny + 1, device=dev, dtype=torch.int32) * s
        tx = torch.arange(-nx, nx + 1, device=dev, dtype=torch.int32) * s
        want = (K.volume_pair_plain(*base, ty, tx, KNOWN_CAP) if pair
                else K.volume_plain(*base, ty, tx))
        fns = {k: raw_launcher(lib, args) for k, lib in libs.items()}
        got = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        err = {k: float((v - want).abs().max()) for k, v in got.items()}
        for v in got.values():
            torch.testing.assert_close(v, want, rtol=RTOL, atol=ATOL)
        dev_ms = {k: [] for k in fns}
        for k in ("prev", "current", "current", "prev"):
            if k in fns:
                dev_ms[k].append(CT.graph_ms(fns[k]))
        row = {"shape": name, "out": list(want.shape), "stride": s,
               "pair": pair, "max_abs_err": err}
        for k, fn in fns.items():
            row[f"{k}_device_ms"] = dev_ms[k]
            row[f"{k}_event_ms"] = CT.event_ms(fn)
            row[f"{k}_host_us"] = CT.host_us(fn)
        wrapper = K.SCORE_VOLUME if len(args) == 8 else K.SCORE_VOLUME_STRIDED
        row["current_wrapper_host_us"] = CT.host_us(lambda: wrapper(*args))
        for probe in (K.PROBE_NO_GATHER, K.PROBE_CONST_CELLS):
            row[f"probe_{probe.mode}_device_ms"] = CT.graph_ms(
                lambda probe=probe: probe(*base, ny, nx, s, s))
        n_off = (2 * ny + 1) * (2 * nx + 1)
        p = cells_[0].shape[-1]
        row["issue_floor_ms_at_max_clock"] = CT.issue_floor_ms(
            b * t * n_off * p, ghz)
        row["bound_ms"], row["bound_by"] = CT.volume_bound(
            ng * cells * cells * 4, b, t, p, n_off, want.numel(),
            int(cells_[2].sum()))
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps({"card": card, "max_sm_clock_ghz": ghz,
                                 "source_sha1": sha1, "rows": rows},
                                indent=1))
    print(f"wrote {os.path.relpath(a.out, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
