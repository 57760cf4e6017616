"""``cg_mrslam --idRobot r`` — one robot per process, datagrams between them —
in the port's command line and in the reference's, at the small scale of
``tests/test_torch_cli_mr.py``: robots 0 and 1 as two subprocesses per
package, the port's through ``cli.main(argv, device="cpu")``, the
reference's as ``python -m cg_mrslam_tpu`` with ``JAX_PLATFORMS=cpu``, all
four at once, each package's pair on its own free ports.

The bars are structural only: when a datagram lands depends on how fast
each process runs, so the outcome varies from run to run. Every process
exits 0 and writes its ``.g2o``, its map and its stats JSON; the port's
stats JSON has the reference's keys, says ``native`` transport and the
``cpu`` backend; on both packages' robots the peer's vertices are present
and no datagram failed to decode. The port's robots also write their ping
and message logs (``--record-pings``, ``--record-msgs``) and start their
loops at one common time (``--start-at``, the port's addition).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

from torch_port_helpers import free_base_port

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["cg_mrslam", "--nRobots", "2", "--modality", "sim", "-o", "u",
        "--ticks", "100", "--beams", "90", "--max-vertices", "64",
        "--max-edges", "256", "--world-width", "16", "--world-height", "10",
        "--max-range", "8", "--resolution", "0.05", "--tick-seconds", "0.2"]
PORT_MAIN = ("import sys, torch; torch.set_num_threads(1); "
             "from cg_mrslam_tpu_torch import cli; "
             "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def _start(package, robot, base, cwd, start_at):
    argv = ARGS + ["--idRobot", str(robot), "--basePort", str(base),
                   "--stats-json", f"stats-{robot}.json"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    if package == "port":
        argv += ["--record-pings", f"pings-{robot}.jsonl",
                 "--record-msgs", f"msgs-{robot}.jsonl",
                 "--start-at", repr(start_at)]
        cmd = [sys.executable, "-c", PORT_MAIN] + argv
    else:
        cmd = [sys.executable, "-m", "cg_mrslam_tpu"] + argv
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_udp_nodes_of_both_packages(tmp_path):
    runs = {}
    start_at = time.time() + 15.0       # the port's pair starts together
    for k, package in enumerate(("ref", "port")):
        d = tmp_path / package
        d.mkdir()
        base = free_base_port(2, slot=k)
        runs[package] = (d, [_start(package, r, base, d, start_at)
                             for r in range(2)])
    stats = {}
    for package, (d, procs) in runs.items():
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=900)
            assert p.returncode == 0, (package, r, out[-3000:])
            assert f"robot {r}/2 on 127.0.0.1:" in out and \
                "native transport" in out, out[:500]
            for suffix in (".g2o", "-map.pgm", "-map.yaml"):
                assert (d / f"robot-{r}-u{suffix}").stat().st_size > 0
            s = json.loads((d / f"stats-{r}.json").read_text())
            assert s["decode_errors"] == 0, (package, s)
            assert s["foreign_vertices"] > 0, (package, s)
            assert s["received"] > 0 and s["transport"] == "native", s
            stats[package, r] = s
    for r in range(2):
        assert stats["port", r].keys() == stats["ref", r].keys()
        assert stats["port", r]["backend"] == "cpu"
        d = runs["port"][0]
        assert (d / f"pings-{r}.jsonl").stat().st_size > 0
        lines = (d / f"msgs-{r}.jsonl").read_text().splitlines()
        kinds = {(e["dir"], e["type"]) for e in map(json.loads, lines)}
        assert {("sent", 0), ("recv", 0), ("sent", 4), ("recv", 4)} <= kinds
