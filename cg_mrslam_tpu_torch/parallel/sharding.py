"""Multi-process sharding of batched pose-graph solves.

Port of ``cg_mrslam_tpu/parallel/sharding.py``. Two orthogonal mesh
dimensions:

* ``graphs`` — data parallelism over independent SLAM worlds (replicas,
  per-robot graphs, parameter sweeps). No communication.
* ``shard`` — the graph dimension: the EDGES of each graph are sharded
  across processes; every process assembles the normal-equation
  contribution of its edge shard and an ``all_reduce`` over the ``shard``
  group sums H and b before the (replicated) solve.

The reference is single-controller (``shard_map`` slices one program over
the devices); ``torch.distributed`` is multi-controller, so here each
process holds only its block (:func:`shard_batch`) and the caller starts
one process per mesh position. The reference's local assembly adds into
H, b and the diagonal blocks with ``.at[].add``; the port sums in a fixed
order (one-hot products for the dense H, ``solver/fixed_sum.py`` tables
for the matrix-free path), so two runs on the same inputs agree bit for
bit. These solves are XLA code in the reference and run as torch
operations here (``cholesky_ex`` / ``cholesky_solve`` for the dense
solve); they launch no hand-written kernel.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.core.graph import PoseGraph, degrees, unpack_info
from cg_mrslam_tpu_torch.core.linearize import flat_ends, linearize
from cg_mrslam_tpu_torch.solver import fixed_sum as FS
from cg_mrslam_tpu_torch.solver import gauss_newton as gn
from cg_mrslam_tpu_torch.utils import se2

EDGE_FIELDS = ("e_ij", "e_z", "e_info", "emask", "e_level", "e_owner")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices: int, shard: int = 2, device_type: str | None = None,
              backend: str | None = None):
    """A ``DeviceMesh`` of dimensions ``("graphs", "shard")`` over the
    ``n_devices`` processes of the initialized default process group
    (``n_devices // shard`` rows of ``shard``). ``device_type`` is the
    card's (``"cuda"``) unless the caller names another; the mesh's groups
    run on ``backend``: NCCL for ``cuda``, gloo for ``cpu``, unless the
    caller names one, and the process group must have been started with
    it. Raises when no process group is initialized: the caller starts one
    process per mesh position and initializes the group itself."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no torch.distributed process group is initialized; "
            "start one process per mesh position and call "
            "init_process_group first")
    device_type = resolve_device(device_type).type
    backend = backend or BACKENDS[device_type]
    if dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, the mesh asks for {backend}")
    world = dist.get_world_size()
    if n_devices != world or n_devices % shard:
        raise ValueError(f"make_mesh: {n_devices} devices in rows of {shard} "
                         f"over a world of {world} processes")
    return init_device_mesh(device_type, (n_devices // shard, shard),
                            mesh_dim_names=("graphs", "shard"))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _dim_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def shard_batch(g: PoseGraph, mesh) -> PoseGraph:
    """This rank's block of a batched graph ``[B, ...]``: the rows of its
    ``graphs`` position, its ``shard`` slice of the edge arrays, and the
    vertex arrays replicated along the row, on the mesh's device. An edge
    count that does not divide by ``shard`` is padded with masked slots."""
    rows, cols = _dim_size(mesh, "graphs"), _dim_size(mesh, "shard")
    gi = mesh.get_local_rank("graphs")
    si = mesh.get_local_rank("shard")
    b, e = g.e_ij.shape[:2]
    if b % rows:
        raise ValueError(f"shard_batch: {b} graphs over {rows} rows")
    bl, el = b // rows, -(-e // cols)
    dev = _mesh_device(mesh)

    def put(name: str, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)[gi * bl:(gi + 1) * bl]
        if name in EDGE_FIELDS:
            pad = el * cols - e
            if pad:
                x = torch.cat([x, x.new_zeros((bl, pad) + x.shape[2:])], 1)
            x = x[:, si * el:(si + 1) * el]
        return x.to(dev).contiguous()

    return PoseGraph(**{f.name: put(f.name, getattr(g, f.name))
                        for f in dataclasses.fields(g)})


def gather_poses(poses: torch.Tensor, mesh) -> torch.Tensor:
    """The full ``[B, N, 3]`` poses from every rank's ``[B/rows, N, 3]``
    (gathered over the ``graphs`` dimension; replicated along ``shard``)."""
    parts = [torch.empty_like(poses)
             for _ in range(_dim_size(mesh, "graphs"))]
    dist.all_gather(parts, poses.contiguous(), group=mesh.get_group("graphs"))
    return torch.cat(parts)


def _edge_terms(poses, e_ij, e_z, e_info, emask):
    """Per-edge linearization of a batch: errors, Jacobians and the masked
    information, each ``[B, E, ...]``."""
    e, Ji, Jj = linearize(poses, e_ij, e_z)
    omega = unpack_info(e_info) * emask.to(poses.dtype)[..., None, None]
    return e, Ji, Jj, omega


def sharded_optimize(g: PoseGraph, mesh, iterations: int = 5):
    """Batched GN with edge-sharded Hessian assembly.

    ``g`` is this rank's block from :func:`shard_batch`. Per iteration
    each rank assembles H, b and the degrees of its graphs from its edge
    shard, ``all_reduce`` over the ``shard`` group sums them, and the
    batched Cholesky solve runs replicated (fixed, untouched or dead
    coordinates pinned by an identity row). Returns the optimized poses of
    the block's graphs ``[B/rows, N, 3]`` (:func:`gather_poses` gathers
    the batch)."""
    group = mesh.get_group("shard")
    poses = g.poses
    dt = poses.dtype
    for _ in range(iterations):
        H, b, deg = gn.batched_normal_eq(poses, g.e_ij, g.e_z, g.e_info,
                                         g.emask)
        for t in (H, b, deg):
            dist.all_reduce(t, group=group)
        free = g.vmask & ~g.fixed & (deg > 0)
        free3 = torch.repeat_interleave(free, 3, dim=-1).to(dt)
        Hf = H * free3[:, :, None] * free3[:, None, :]
        Hf = Hf + torch.diag_embed(1.0 - free3)
        dx = -torch.cholesky_solve((b * free3)[..., None],
                                   gn._cholesky(Hf))[..., 0] * free3
        poses = se2.oplus(poses, dx.reshape(poses.shape))
    return poses


def _local_pcg_factors(poses, e_ij, e_z, e_info, emask, table):
    """Per-edge-shard linearization for the matrix-free path: the edge
    terms, the gradient blocks ``[B, N, 3]``, the block-diagonal Hessian
    blocks ``[B, N, 3, 3]`` and the degrees (all to be reduced), summed
    through the fixed-order ``table``."""
    e, Ji, Jj, omega = _edge_terms(poses, e_ij, e_z, e_info, emask)
    JiT_O = Ji.transpose(-1, -2) @ omega
    JjT_O = Jj.transpose(-1, -2) @ omega
    bi = (JiT_O @ e[..., None])[..., 0]
    bj = (JjT_O @ e[..., None])[..., 0]
    b = FS.ends_sum(table, bi, bj)
    d = FS.ends_sum(table, JiT_O @ Ji, JjT_O @ Jj)
    return (Ji, Jj, omega), b, d, degrees(e_ij, emask, poses.shape[1])


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Per-graph sum of a ``[B, N, 3]`` product, ``[B, 1, 1]``."""
    return x.reshape(x.shape[0], -1).sum(-1)[:, None, None]


def sharded_optimize_pcg(g: PoseGraph, mesh, iterations: int = 5,
                         cg_iters: int = 64):
    """Matrix-free sharded GN: H is never formed. Each CG iteration
    computes the Hessian-vector product of the rank's edge shard and an
    ``all_reduce`` over ``shard`` sums the ``[B, N, 3]`` vector. The
    preconditioner is block Jacobi, from the reduced 3×3 diagonal blocks.
    ``cg_iters`` CG iterations every GN iteration (no early exit, as in
    the reference's ``scan``). Returns the block's poses
    ``[B/rows, N, 3]``."""
    group = mesh.get_group("shard")
    poses = g.poses
    bl, n = poses.shape[:2]
    dt = poses.dtype
    flat = flat_ends(poses, g.e_ij)
    table = FS.edge_table(g.e_ij, g.emask, n).table
    eye = torch.eye(3, dtype=dt, device=poses.device)
    for _ in range(iterations):
        (Ji, Jj, omega), b, diag, deg = _local_pcg_factors(
            poses, g.e_ij, g.e_z, g.e_info, g.emask, table)
        for t in (b, diag, deg):
            dist.all_reduce(t, group=group)
        free = g.vmask & ~g.fixed & (deg > 0)
        freeb = free[..., None].to(dt)
        dsafe = torch.where(free[..., None, None], diag, eye) + 1e-6 * eye
        minv = torch.linalg.inv(dsafe)

        def hvp(x):
            xf = x.reshape(-1, 3)
            xi = xf[flat[..., 0]]                                # [B,E,3]
            xj = xf[flat[..., 1]]
            r = omega @ ((Ji @ xi[..., None]) + (Jj @ xj[..., None]))
            yi = (Ji.transpose(-1, -2) @ r)[..., 0]
            yj = (Jj.transpose(-1, -2) @ r)[..., 0]
            y = FS.ends_sum(table, yi, yj)
            dist.all_reduce(y, group=group)
            return y * freeb

        def precond(r):
            return (minv @ r[..., None])[..., 0] * freeb

        x = torch.zeros_like(poses)
        r = -b * freeb
        z = precond(r)
        p, rz = z, _sum(r * z)
        for _ in range(cg_iters):
            hp = hvp(p)
            alpha = rz / torch.clamp(_sum(p * hp), min=1e-30)
            x = x + alpha * p
            r = r - alpha * hp
            z = precond(r)
            rz2 = _sum(r * z)
            p = z + rz2 / torch.clamp(rz, min=1e-30) * p
            rz = rz2
        poses = se2.oplus(poses, x)
    return poses
