"""``.g2o`` text format reader and writer (VERTEX_SE2, EDGE_SE2, FIX,
ROBOTLASER1 and the ``# CGM_EDGE_META`` provenance comments).

Port of ``cg_mrslam_tpu/io/g2o.py``: the reference's graph files
(``graph_slam.cpp:620-628`` saves one after every keyframe; a ROBOTLASER1
line follows each vertex). g2o ids may be namespaced (``id = runningId +
robotId·baseId``, ``graph_slam.cpp:155``); they are kept in a side ``ids``
array while the graph's slots stay dense.

:func:`load` parses with the native C++ parser (``native=True``, the
default) or in Python (``native=False``); the caller picks one, and the
code never switches from one to the other. Both build the same arrays and
one :func:`_assemble` turns them into tensors on the requested device (the
card unless the caller names another).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.core import graph as G
from cg_mrslam_tpu_torch.core import scan as S
from cg_mrslam_tpu_torch.utils import se2


@dataclasses.dataclass
class LoadedGraph:
    graph: G.PoseGraph
    ids: np.ndarray                # [N] int64 original g2o ids (-1 unused)
    scans: Optional[S.ScanSet]     # aligned with graph slots, or None
    has_edge_meta: bool = False    # CGM_EDGE_META provenance lines present


def _floats(tok, start: int, n: int) -> list:
    """``n`` numbers from ``tok[start:]``; raises when there are fewer."""
    if len(tok) < start + n:
        raise ValueError(f"malformed .g2o line: {' '.join(tok)[:80]}")
    return [float(x) for x in tok[start:start + n]]


def _parse_python(path: str) -> dict:
    """The arrays of ``native.parse_g2o``, parsed line by line in Python
    (a malformed line raises)."""
    v_ids, v_pose, fixed, e_ids, e_z, e_info = [], [], set(), [], [], []
    l_vertex, l_meta, l_ranges = [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            tag = tok[0]
            if tag == "VERTEX_SE2":
                v_pose.append(_floats(tok, 2, 3))
                v_ids.append(int(tok[1]))
            elif tag == "FIX":
                fixed.update(int(t) for t in tok[1:])
            elif tag == "EDGE_SE2":
                e_z.append(_floats(tok, 3, 3))
                e_info.append(_floats(tok, 6, 6))
                e_ids.append([int(tok[1]), int(tok[2])])
            elif tag == "ROBOTLASER1" and v_ids:
                # type fba fov step maxr accuracy remission beams r[beams]
                # remCount [rem...] laserPose(3) odomPose(3) ...
                nb = int(tok[8])
                k = 10 + nb + int(tok[9 + nb])
                l_meta.append(_floats(tok, 2, 4) + _floats(tok, k, 6))
                l_ranges.append(_floats(tok, 9, nb))
                l_vertex.append(len(v_ids) - 1)
    mb = max([len(r) for r in l_ranges], default=1)
    ranges = np.zeros((len(l_ranges), mb))
    for k, r in enumerate(l_ranges):
        ranges[k] = r + [l_meta[k][3]] * (mb - len(r))
    return {
        "v_ids": np.asarray(v_ids, np.int64).reshape(-1),
        "v_pose": np.asarray(v_pose, np.float64).reshape(-1, 3),
        "v_fixed": np.asarray([v in fixed for v in v_ids], np.uint8),
        "e_ids": np.asarray(e_ids, np.int64).reshape(-1, 2),
        "e_z": np.asarray(e_z, np.float64).reshape(-1, 3),
        "e_info": np.asarray(e_info, np.float64).reshape(-1, 6),
        "l_vertex": np.asarray(l_vertex, np.int64),
        "l_meta": np.asarray(l_meta, np.float64).reshape(-1, 10),
        "l_ranges": ranges,
    }


def _edge_meta(path: str) -> dict:
    """``# CGM_EDGE_META <ordinal> <owner> <level>`` lines (written by
    :func:`save`; ordinal = position among the EDGE_SE2 lines)."""
    meta = {}
    with open(path) as f:
        for line in f:
            if line.startswith("# CGM_EDGE_META"):
                tok = line.split()
                meta[int(tok[2])] = (int(tok[3]), int(tok[4]))
    return meta


def load(path: str, max_vertices: int | None = None,
         max_edges: int | None = None, beams: int | None = None,
         dtype: torch.dtype = torch.float32, native: bool = True,
         device=None) -> LoadedGraph:
    """Read a ``.g2o`` file into a graph of the given capacity (the file's
    counts by default), with its scans and edge provenance; the graph's
    poses, measurements and information in ``dtype``. ``native`` parses
    with the C++ parser (which raises when it cannot be built or the file
    is malformed), otherwise in Python."""
    if native:
        from cg_mrslam_tpu_torch import native as N

        p = N.parse_g2o(path)
    else:
        p = _parse_python(path)
    return _assemble(p, _edge_meta(path), max_vertices, max_edges, beams,
                     resolve_device(device), dtype)


def _assemble(p: dict, meta: dict, max_vertices, max_edges, beams,
              dev: torch.device, dtype: torch.dtype) -> LoadedGraph:
    n = p["v_ids"].shape[0]
    e = p["e_ids"].shape[0]
    cap_v = max_vertices or n
    cap_e = max_edges or max(e, 1)
    if n > cap_v or e > cap_e:
        raise ValueError(
            f"graph ({n} v, {e} e) exceeds capacity ({cap_v}, {cap_e})")

    ids = np.full((cap_v,), -1, np.int64)
    ids[:n] = p["v_ids"]
    poses = np.zeros((cap_v, 3), np.float64)
    poses[:n] = p["v_pose"]
    vmask = np.arange(cap_v) < n
    fix = np.zeros((cap_v,), bool)
    fix[:n] = p["v_fixed"].astype(bool)
    if n and not fix.any():
        fix[0] = True  # g2o needs a gauge; the reference fixes the first

    # id -> slot by sorted lookup (ids may be sparse or namespaced)
    order = np.argsort(p["v_ids"], kind="stable")
    sorted_ids = p["v_ids"][order]

    def slot_of(raw):
        pos = np.clip(np.searchsorted(sorted_ids, raw), 0, max(n - 1, 0))
        if n == 0 or not (sorted_ids[pos] == raw).all():
            raise ValueError("edge references an unknown vertex id")
        return order[pos]

    e_ij = np.zeros((cap_e, 2), np.int32)
    e_z = np.zeros((cap_e, 3), np.float64)
    e_info = np.zeros((cap_e, 6), np.float64)
    e_owner = np.zeros((cap_e,), np.int32)
    e_level = np.zeros((cap_e,), np.int32)
    if e:
        e_ij[:e] = slot_of(p["e_ids"])
        e_z[:e] = p["e_z"]
        e_info[:e] = p["e_info"]
    for ordinal, (owner, level) in meta.items():
        e_owner[ordinal], e_level[ordinal] = owner, level

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=dev)

    f32 = torch.float32
    g = G.PoseGraph(
        poses=t(poses, dtype), vmask=t(vmask, torch.bool),
        fixed=t(fix, torch.bool), e_ij=t(e_ij, torch.int32),
        e_z=t(e_z, dtype), e_info=t(e_info, dtype),
        emask=t(np.arange(cap_e) < e, torch.bool),
        e_level=t(e_level, torch.int32), e_owner=t(e_owner, torch.int32),
        n_vertices=torch.tensor(n, dtype=torch.int32, device=dev),
        n_edges=torch.tensor(e, dtype=torch.int32, device=dev))

    scans = None
    if p["l_vertex"].shape[0]:
        m0 = p["l_meta"][0]
        b = beams or p["l_ranges"].shape[1]
        scans = S.empty(cap_v, b, dev, first_beam_angle=float(m0[0]),
                        angular_step=float(m0[2]), max_range=float(m0[3]),
                        fov=float(m0[1]))
        ranges = np.full((cap_v, b), float(m0[3]), np.float32)
        smask = np.zeros((cap_v,), bool)
        slots = p["l_vertex"]
        w = min(b, p["l_ranges"].shape[1])
        ranges[slots, :w] = p["l_ranges"][:, :w]
        smask[slots] = True
        # base→laser offset from the first scan: odom⁻¹ ∘ laserPose
        off = se2.relative(t(m0[7:10], f32), t(m0[4:7], f32))
        scans = dataclasses.replace(scans, ranges=t(ranges, f32),
                                    smask=t(smask, torch.bool),
                                    laser_offset=off)
    return LoadedGraph(graph=g, ids=ids, scans=scans,
                       has_edge_meta=bool(meta))


def save(path: str, g: G.PoseGraph, ids: np.ndarray | None = None,
         scans: S.ScanSet | None = None) -> None:
    """Write a g2o text file (the reference's ``saveGraph``); the same
    bytes as the reference's writer for the same graph."""
    poses = g.poses.detach().cpu().numpy().astype(np.float64)
    vmask = g.vmask.cpu().numpy()
    fix = g.fixed.cpu().numpy()
    e_ij = g.e_ij.cpu().numpy()
    e_z = g.e_z.cpu().numpy().astype(np.float64)
    e_info = g.e_info.cpu().numpy().astype(np.float64)
    emask = g.emask.cpu().numpy()
    e_owner = g.e_owner.cpu().numpy()
    e_level = g.e_level.cpu().numpy()
    n = poses.shape[0]
    if ids is None:
        ids = np.arange(n, dtype=np.int64)

    if scans is not None:
        ranges = scans.ranges.cpu().numpy().astype(np.float64)
        smask = scans.smask.cpu().numpy()
        fba = float(scans.first_beam_angle)
        step = float(scans.angular_step)
        mr = float(scans.max_range)
        fov = step * ranges.shape[1]
        off = scans.laser_offset.cpu().numpy().astype(np.float64)
        # laser poses: pose ∘ offset, in float64
        c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
        th = poses[:, 2] + off[2]
        lpose = np.stack([poses[:, 0] + c * off[0] - s * off[1],
                          poses[:, 1] + s * off[0] + c * off[1],
                          th - 2 * np.pi * np.round(th / (2 * np.pi))], 1)

    with open(path, "w") as f:
        for k in range(n):
            if not vmask[k]:
                continue
            f.write(f"VERTEX_SE2 {ids[k]} {poses[k,0]:.6f} {poses[k,1]:.6f} "
                    f"{poses[k,2]:.6f}\n")
            if scans is not None and smask[k]:
                rs = " ".join(f"{r:.4f}" for r in ranges[k])
                lp = lpose[k]
                f.write(
                    f"ROBOTLASER1 0 {fba:.6f} {fov:.6f} {step:.6f} {mr:.2f} "
                    f"0.01 0 {ranges.shape[1]} {rs} 0 "
                    f"{lp[0]:.6f} {lp[1]:.6f} {lp[2]:.6f} "
                    f"{poses[k,0]:.6f} {poses[k,1]:.6f} {poses[k,2]:.6f} "
                    f"0 0 0 0 0 0 hostname 0\n")
            if fix[k]:
                f.write(f"FIX {ids[k]}\n")
        ordinal = 0
        for k in range(e_ij.shape[0]):
            if not emask[k]:
                continue
            i, j = e_ij[k]
            z, w = e_z[k], e_info[k]
            f.write(
                f"EDGE_SE2 {ids[i]} {ids[j]} "
                f"{z[0]:.6f} {z[1]:.6f} {z[2]:.6f} "
                f"{w[0]:.6f} {w[1]:.6f} {w[2]:.6f} {w[3]:.6f} {w[4]:.6f} "
                f"{w[5]:.6f}\n")
            # edge provenance as a comment (g2o tools skip '#'): the owner
            # (the own-edges rule) and the level (condensed-star channel)
            # keep a multi-robot resume from re-condensing peer information
            if e_owner[k] != 0 or e_level[k] != 0:
                f.write(f"# CGM_EDGE_META {ordinal} "
                        f"{int(e_owner[k])} {int(e_level[k])}\n")
            ordinal += 1
