"""Carry state between this package and ``cg_mrslam_tpu`` by value.

A state crosses as a flat dict of numpy arrays keyed by field path
(``"graph.poses"``, ``"buffer.age"``, ``"my_id"``, ...). :func:`to_numpy`
walks any tree of dataclasses whose leaves are tensors or array-likes, so
it flattens the reference's ``SlamState`` as well as this package's; the
reverse builds this package's dataclasses on a device. A ``Config`` crosses
by constructing both packages' dataclasses from the same keyword
arguments.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from cg_mrslam_tpu_torch.pipeline.slam import SlamState


def to_numpy(obj, prefix: str = "") -> dict:
    """Flatten a dataclass tree into ``{field path: numpy array}``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(to_numpy(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def from_numpy(cls, arrays: dict, device, prefix: str = ""):
    """Build dataclass ``cls`` (a field tree of tensors) from
    :func:`to_numpy`'s dict; floats become float32, integers int32."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        sub = hints[f.name]
        key = prefix + f.name
        if dataclasses.is_dataclass(sub):
            kw[f.name] = from_numpy(sub, arrays, device, key + ".")
        else:
            kw[f.name] = _leaf(arrays[key], device)
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """A ``SlamState`` of either package as ``{field path: array}``."""
    return to_numpy(state)


def state_from_numpy(arrays: dict, device) -> SlamState:
    """This package's ``SlamState`` from :func:`state_to_numpy`'s dict."""
    return from_numpy(SlamState, arrays, device)


