"""Start a ``torch.distributed`` process group on one host and run a
function in every process.

``torch.distributed`` is multi-controller: the caller starts one process
per mesh position (``parallel.sharding``, ``parallel.fleet``). This module
does that with ``spawn``ed processes that rendezvous through a
``FileStore`` in a directory of the caller's (no TCP port to pick). Each
process returns its result through a file in that directory. When a rank
fails, or the group does not finish within its timeout, the rest of the
group is killed and the call raises with the ranks' tracebacks, so a hung
collective cannot hold its caller.

    results = run_group(worker, 4, args=(x,), workdir=tmp, backend="gloo")

``worker(rank, world_size, *args)`` must be importable by name (a module
function): ``spawn`` starts every process from a fresh interpreter.
"""

from __future__ import annotations

import time
import traceback
from multiprocessing.connection import wait
from pathlib import Path

import torch
import torch.distributed as dist


def _record_failure(out: Path, rank: int) -> None:
    """``rank{r}.err``: when the rank failed (the host's monotonic clock,
    shared by its processes) and its traceback. The first record stays."""
    err = out / f"rank{rank}.err"
    if not err.exists():
        tmp = out / f"rank{rank}.tmp"      # renamed whole: never read half
        tmp.write_text(f"rank {rank} failed at monotonic_ns "
                       f"{time.monotonic_ns()}\n{traceback.format_exc()}")
        tmp.rename(err)


def _main(rank: int, world: int, target, args, workdir: str,
          backend: str, cuda_index) -> None:
    out = Path(workdir)
    try:
        torch.set_num_threads(1)
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        store = dist.FileStore(str(out / "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        try:
            result = target(rank, world, *args)
        except BaseException:
            # recorded before the group goes down: a peer blocked in a
            # collective fails only after this
            _record_failure(out, rank)
            raise
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        _record_failure(out, rank)
        raise


def run_group(target, world_size: int, args=(), workdir=None,
              backend: str = "gloo", cuda_index: int | None = None,
              timeout: float = 120.0) -> list:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one process group on ``backend``; each process
    uses ``torch.set_num_threads(1)`` and, with ``cuda_index``, that card.
    Returns the ranks' results in rank order. Raises ``RuntimeError`` with
    the tracebacks as soon as a rank fails, and ``TimeoutError`` with any
    tracebacks when the group has not finished within ``timeout`` seconds;
    either way the group's remaining processes are killed first."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = Path(workdir)
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("rank*"):
        f.unlink()
    store = out / "store"
    if store.exists():
        store.unlink()
    procs = [ctx.Process(target=_main, args=(r, world_size, target, args,
                                             str(out), backend, cuda_index),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                # its peers may wait on it in a collective
                raise RuntimeError(f"process group of {world_size}: "
                                   + _failed(out, codes) + "\n"
                                   + _errors(out))
            running = [p.sentinel for p, c in zip(procs, codes) if c is None]
            if not running:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                hung = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"process group of {world_size}: ranks "
                                   f"{hung} still running after {timeout} s"
                                   f"\n" + _errors(out))
            wait(running, left)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def _failed(out: Path, codes) -> str:
    """Which ranks failed, the first to fail apart from those that failed
    after it (a peer whose collective broke when the first went down)."""
    at = {}
    for r, c in enumerate(codes):
        err = out / f"rank{r}.err"
        if err.exists():
            first = err.read_text().split("\n", 1)[0]
            at[r] = int(first.rsplit(" ", 1)[1])
        elif c not in (None, 0):
            at[r] = time.monotonic_ns()     # failed without a record
    first = min(at.values())
    lead = sorted(r for r, t in at.items() if t == first)
    rest = sorted((r for r in at if r not in lead), key=at.get)
    return (f"ranks {lead} failed"
            + (f", then ranks {rest}" if rest else ""))


def _errors(out: Path) -> str:
    """The tracebacks the ranks wrote to ``out``."""
    return "\n".join(f.read_text() for f in sorted(out.glob("rank*.err")))
