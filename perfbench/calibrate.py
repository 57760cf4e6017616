"""Readings that a cell's correctness limits are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds <a> <b> ... \\
        [--seconds <s>] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up and a short window at
the cell's own load, as a run makes them; then, on the same sample of the
window's graphs, the program's numbers against the plain reference (the
lower readings) and the control's, the reference computed in TF32 put in
the program's place (the upper readings). One JSON line per seed. Needs
the card; the benchmark's own runs never run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.lib import calibration, harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("perfbench: calibration needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(ROOT, args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            rec = calibration.readings(spec, seed, args.seconds, "cuda")
            rec["device"] = torch.cuda.get_device_name(0)
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
