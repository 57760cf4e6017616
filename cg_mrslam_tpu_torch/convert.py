"""Carry state between this package and ``cg_mrslam_tpu`` by value.

A state crosses as a flat dict of numpy arrays keyed by field path
(``"graph.poses"``, ``"buffer.age"``, ``"my_id"``, ...). :func:`to_numpy`
walks any tree of dataclasses and named tuples whose leaves are tensors or
array-likes, so it flattens the reference's ``SlamState``, ``MRState``
(with its per-peer ``ClosureBuffer``) and messages (``Combo``,
``ClosureList``, ``StarMsg``) as well as this package's; the reverse builds
this package's types on a device. A ``Config`` crosses by constructing both
packages' dataclasses from the same keyword arguments. :func:`tree_map` and
:func:`tree_leaves` walk the same trees within this package.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from cg_mrslam_tpu_torch.pipeline.slam import SlamState


def _fields(obj_or_cls) -> tuple:
    if dataclasses.is_dataclass(obj_or_cls):
        return tuple(f.name for f in dataclasses.fields(obj_or_cls))
    return obj_or_cls._fields                                # a NamedTuple


def _is_node(v) -> bool:
    return dataclasses.is_dataclass(v) or hasattr(v, "_fields")


def to_numpy(obj, prefix: str = "") -> dict:
    """Flatten a tree of dataclasses / named tuples into ``{field path:
    numpy array}``."""
    out = {}
    for name in _fields(obj):
        v = getattr(obj, name)
        key = prefix + name
        if _is_node(v):
            out.update(to_numpy(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of dataclass / named-tuple trees of one
    structure (``jax.tree_util.tree_map`` for this package's states and
    messages)."""
    t0 = trees[0]
    if not _is_node(t0):
        return fn(*trees)
    return type(t0)(**{name: tree_map(fn, *(getattr(t, name) for t in trees))
                       for name in _fields(t0)})


def tree_leaves(tree) -> list:
    """The leaves of a tree in :func:`tree_map`'s order."""
    if not _is_node(tree):
        return [tree]
    return [leaf for name in _fields(tree)
            for leaf in tree_leaves(getattr(tree, name))]


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def from_numpy(cls, arrays: dict, device, prefix: str = ""):
    """Build ``cls`` (a dataclass or named tuple whose fields are tensors or
    such types) from :func:`to_numpy`'s dict; floats become float32,
    integers int32."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for name in _fields(cls):
        sub = hints[name]
        key = prefix + name
        if isinstance(sub, type) and _is_node(sub):
            kw[name] = from_numpy(sub, arrays, device, key + ".")
        else:
            kw[name] = _leaf(arrays[key], device)
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """A ``SlamState`` of either package as ``{field path: array}``."""
    return to_numpy(state)


def state_from_numpy(arrays: dict, device) -> SlamState:
    """This package's ``SlamState`` from :func:`state_to_numpy`'s dict."""
    return from_numpy(SlamState, arrays, device)


def mr_state_from_numpy(arrays: dict, device):
    """This package's ``MRState`` from :func:`to_numpy`'s dict of either
    package's."""
    from cg_mrslam_tpu_torch.mr.mrslam import MRState

    return from_numpy(MRState, arrays, device)


def message_from_numpy(cls, msg, device):
    """A message of the reference (``Combo``, ``ClosureList``,
    ``StarMsg``) as this package's ``cls``."""
    return from_numpy(cls, to_numpy(msg), device)
