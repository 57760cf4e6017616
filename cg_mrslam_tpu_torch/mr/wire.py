"""Binary wire codec for inter-robot messages.

Port of ``cg_mrslam_tpu/mr/wire.py`` (the reference's hand-rolled
serialization, ``msg_factory.h:45-115``): a type-tagged header (int type,
int robot id, int float32 count), every number sent as float32
(``msg_factory.h:78-112``), a 100 000-byte datagram bound
(``msg_factory.h:115``). The type tags keep the reference's values. For the
same message, :func:`encode` writes the same bytes as the JAX package's, so
processes of the two packages talk to each other.

:func:`encode` takes messages whose fields are tensors on any device (or
numbers); their tensors reach the host in one copy. :func:`decode` parses on
the host and moves the message to ``device`` (the card by default) in one
copy, then slices and converts it there.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cg_mrslam_tpu_torch import resolve_device
from cg_mrslam_tpu_torch.mr.mrslam import (ClosureList, Combo, EdgeArray,
                                           GraphMsg, RobotLaser, StarMsg,
                                           VertexArray)

MAX_DATAGRAM = 100_000           # msg_factory.h:115
TYPE_PING = 0                    # comm_publisher beacon (comm_publisher.cpp:
#                                  50-82); not in the reference's registry
TYPE_VERTEX_ARRAY = 1            # msg_factory.h:141-271 tag values
TYPE_ROBOT_LASER = 2
TYPE_COMBO = 4
TYPE_EDGE_ARRAY = 5
TYPE_CLOSURES = 6
TYPE_CONDENSED = 7
TYPE_GRAPH = 8

HEADER = struct.Struct("<iii")   # type, robot id, payload float32 count


class Ping(NamedTuple):
    """Connectivity beacon. The reference's comm_publisher broadcasts a bare
    robot id; this one also carries the sender's position, so the sim
    modality's range gate works across processes."""

    robot: int
    x: float
    y: float


def _pack(msg_type: int, robot: int, *parts) -> bytes:
    """Header + the parts flattened to float32. Tensor parts (all on one
    device) are converted there and copied to the host together."""
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    host = (torch.cat([t.detach().reshape(-1).to(torch.float32)
                       for t in tensors]).cpu().numpy() if tensors else None)
    flat, o = [], 0
    for p in parts:
        if isinstance(p, torch.Tensor):
            flat.append(host[o:o + p.numel()])
            o += p.numel()
        else:
            flat.append(np.asarray(p, np.float32).reshape(-1))
    flat = np.concatenate(flat)
    out = HEADER.pack(msg_type, int(robot), flat.size) + flat.tobytes()
    if len(out) > MAX_DATAGRAM:
        raise ValueError(
            f"message {len(out)} B exceeds datagram bound {MAX_DATAGRAM}")
    return out


def encode(msg, robot: int = -1) -> bytes:
    """Serialize one message (``robot`` names the sender of a closure list
    or a star, which do not carry it)."""
    if isinstance(msg, Ping):
        return _pack(TYPE_PING, int(msg.robot), [msg.x, msg.y])
    if isinstance(msg, GraphMsg):
        return _pack(TYPE_GRAPH, int(msg.robot), [msg.poses.shape[0]],
                     msg.poses, msg.idxs, msg.vvalid, msg.e_ij, msg.e_z,
                     msg.e_info, msg.evalid)
    if isinstance(msg, Combo):
        return _pack(TYPE_COMBO, int(msg.robot),
                     [msg.poses.shape[0], msg.ranges.shape[0]],
                     msg.first_beam_angle, msg.angular_step, msg.max_range,
                     msg.poses, msg.idxs, msg.valid, msg.ranges)
    if isinstance(msg, VertexArray):
        return _pack(TYPE_VERTEX_ARRAY, int(msg.robot), [msg.poses.shape[0]],
                     msg.poses, msg.idxs, msg.valid)
    if isinstance(msg, RobotLaser):
        return _pack(TYPE_ROBOT_LASER, int(msg.robot), msg.node_id,
                     msg.first_beam_angle, msg.angular_step, msg.max_range,
                     msg.accuracy, msg.ranges)
    if isinstance(msg, EdgeArray):
        return _pack(TYPE_EDGE_ARRAY, int(msg.robot), [msg.ids.shape[0]],
                     msg.ids, msg.z, msg.info, msg.valid)
    if isinstance(msg, ClosureList):
        return _pack(TYPE_CLOSURES, robot, msg.idxs, msg.valid)
    if isinstance(msg, StarMsg):
        return _pack(TYPE_CONDENSED, robot, msg.gauge, msg.boundary, msg.z,
                     msg.info, msg.valid)
    raise TypeError(type(msg))


def _count(flat: np.ndarray, k: int, name: str) -> int:
    """Header field ``k`` of the payload as a count; ValueError if it is
    not a count the payload can hold."""
    if flat.size <= k or not 0 <= flat[k] <= flat.size:
        raise ValueError(f"malformed {name} message")
    return int(flat[k])


def decode(buf: bytes, beams: int | None = None, device=None
           ) -> Tuple[int, object]:
    """Deserialize; returns ``(sender robot id, message)`` with the
    message's tensors on ``device`` (the card by default). Raises
    ``ValueError`` on a malformed datagram. ``beams`` is accepted for the
    reference's signature and unused: every scan-carrying message says its
    own beam count and geometry, and the receiver resamples."""
    if len(buf) < HEADER.size:
        raise ValueError(f"datagram of {len(buf)} B has no header")
    t, robot, count = HEADER.unpack_from(buf, 0)
    if count < 0 or HEADER.size + 4 * count > len(buf):
        raise ValueError(f"datagram of {len(buf)} B cannot hold {count} "
                         "floats")
    flat = np.frombuffer(buf, np.float32, count, HEADER.size)
    if t == TYPE_PING:
        if count < 2:
            raise ValueError("malformed ping")
        return robot, Ping(robot=robot, x=float(flat[0]), y=float(flat[1]))
    dev = resolve_device(device)
    ft = torch.from_numpy(flat.copy()).to(dev)     # the one host copy
    sizes = []

    def take(n, shape=None, kind="f"):
        """The next ``n`` floats as a tensor (``"i"``: int32, ``"b"``: bool
        from the wire's 0/1)."""
        o = sum(sizes)
        if o + n > count:
            raise ValueError(f"message type {t} is truncated")
        sizes.append(n)
        x = ft[o:o + n]
        x = x.reshape(shape) if shape is not None else x
        return (x.to(torch.int32) if kind == "i" else
                x > 0.5 if kind == "b" else x)

    rid = torch.full((), robot, dtype=torch.int32, device=dev)
    if t == TYPE_GRAPH:
        v = _count(flat, 0, "graph")
        take(1)
        poses, idxs, vvalid = (take(3 * v, (v, 3)), take(v, kind="i"),
                               take(v, kind="b"))
        e = (count - sum(sizes)) // 12   # e_ij 2E + z 3E + info 6E + valid E
        return robot, GraphMsg(
            robot=rid, poses=poses, idxs=idxs, vvalid=vvalid,
            e_ij=take(2 * e, (e, 2), "i"), e_z=take(3 * e, (e, 3)),
            e_info=take(6 * e, (e, 6)), evalid=take(e, kind="b"))
    if t == TYPE_COMBO:
        # header [C, B, first beam angle, step, max range]
        c, b = _count(flat, 0, "combo"), _count(flat, 1, "combo")
        take(2)
        fba, step, maxr = take(1)[0], take(1)[0], take(1)[0]
        return robot, Combo(robot=rid, poses=take(3 * c, (c, 3)),
                            idxs=take(c, kind="i"), valid=take(c, kind="b"),
                            ranges=take(b), first_beam_angle=fba,
                            angular_step=step, max_range=maxr)
    if t == TYPE_VERTEX_ARRAY:
        c = _count(flat, 0, "vertex array")
        take(1)
        return robot, VertexArray(robot=rid, poses=take(3 * c, (c, 3)),
                                  idxs=take(c, kind="i"),
                                  valid=take(c, kind="b"))
    if t == TYPE_ROBOT_LASER:
        node_id, fba, step, maxr, acc = (take(1)[0] for _ in range(5))
        return robot, RobotLaser(robot=rid, node_id=node_id.to(torch.int32),
                                 ranges=take(count - 5),
                                 first_beam_angle=fba, angular_step=step,
                                 max_range=maxr, accuracy=acc)
    if t == TYPE_EDGE_ARRAY:
        e = _count(flat, 0, "edge array")
        take(1)
        return robot, EdgeArray(robot=rid, ids=take(2 * e, (e, 2), "i"),
                                z=take(3 * e, (e, 3)),
                                info=take(6 * e, (e, 6)),
                                valid=take(e, kind="b"))
    if t == TYPE_CLOSURES:
        half = count // 2
        return robot, ClosureList(
            idxs=take(half, kind="i"), valid=take(half, kind="b"),
            dropped=torch.zeros((), dtype=torch.int32, device=dev))
    if t == TYPE_CONDENSED:
        k = (count - 1) // 11            # gauge 1 + K(1 + 3 + 6 + 1)
        return robot, StarMsg(
            gauge=take(1, kind="i")[0], boundary=take(k, kind="i"),
            z=take(3 * k, (k, 3)), info=take(6 * k, (k, 6)),
            valid=take(k, kind="b"),
            dropped=torch.zeros((), dtype=torch.int32, device=dev))
    raise ValueError(f"unknown message type {t}")
