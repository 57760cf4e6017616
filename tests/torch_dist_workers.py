"""Worker functions of the port's multi-process tests
(``test_torch_sharding.py``, ``test_torch_fleet.py``), run by
``cg_mrslam_tpu_torch.parallel.launch.run_group`` in spawned processes.
This module imports neither JAX nor the JAX package, so a worker starts
with torch only. Inputs and results cross as numpy dicts
(``convert.to_numpy``)."""

from cg_mrslam_tpu_torch import convert
from cg_mrslam_tpu_torch.core.graph import PoseGraph
from cg_mrslam_tpu_torch.parallel import fleet
from cg_mrslam_tpu_torch.parallel import sharding as SH


def sharded_solve(rank, world, graph, shard, kind, iterations, cg_iters=64):
    """``sharded_optimize`` (``kind`` "dense") or ``sharded_optimize_pcg``
    ("pcg") of the batched graph ``graph`` (numpy dict) on a
    ``(world // shard) x shard`` mesh; returns the gathered poses."""
    mesh = SH.make_mesh(world, shard=shard, device_type="cpu")
    g = convert.from_numpy(PoseGraph, graph, "cpu")
    gs = SH.shard_batch(g, mesh)
    if kind == "dense":
        poses = SH.sharded_optimize(gs, mesh, iterations=iterations)
    else:
        poses = SH.sharded_optimize_pcg(gs, mesh, iterations=iterations,
                                        cg_iters=cg_iters)
    return SH.gather_poses(poses, mesh).numpy()


def sharded_round(rank, world, states, conn, cfg):
    """``fleet_round_sharded`` of robot states ``states`` (numpy dicts, one
    per robot) on a ``robots`` mesh of ``world`` processes; returns this
    rank's block as one numpy dict per robot."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("robots",))
    loc = len(states) // world
    mine = [convert.mr_state_from_numpy(s, "cpu")
            for s in states[rank * loc:(rank + 1) * loc]]
    out = fleet.fleet_round_sharded(fleet.stack_states(mine), conn, cfg,
                                    mesh)
    return [convert.to_numpy(st) for st in fleet.unstack_states(out, loc)]


def card_sharded_repeats(rank, world, batch=64):
    """On the card: ``sharded_optimize`` and ``sharded_optimize_pcg`` of
    ``build_batch(batch)``, each run twice on a ``1 x world`` mesh;
    returns the four gathered pose batches on the host."""
    from cg_mrslam_tpu_torch.sim.graphs import build_batch

    mesh = SH.make_mesh(world, shard=world)
    gs = SH.shard_batch(build_batch(batch), mesh)
    out = []
    for solve in (SH.sharded_optimize, SH.sharded_optimize,
                  SH.sharded_optimize_pcg, SH.sharded_optimize_pcg):
        out.append(SH.gather_poses(solve(gs, mesh), mesh).cpu().numpy())
    return out


def fail_on_last(rank, world):
    """Rank ``world - 1`` raises at once; the others wait for it in a
    barrier that never completes."""
    import torch.distributed as dist

    if rank == world - 1:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def sleep_on_last(rank, world, seconds):
    """Rank ``world - 1`` sleeps ``seconds`` before its barrier; the others
    wait for it there."""
    import time

    import torch.distributed as dist

    if rank == world - 1:
        time.sleep(seconds)
    dist.barrier()
