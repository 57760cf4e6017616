"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages as the
same float32 arrays (``tests/conftest.py`` turns on JAX's x64 mode, so
every JAX input is pinned to float32 explicitly). The port runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cg_mrslam_tpu_torch import convert

CPU = torch.device("cpu")


def npy(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jf(a):
    """numpy → JAX, floats pinned to float32 and ints to int32."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return jnp.asarray(a, jnp.float32)
    if a.dtype.kind in "iu":
        return jnp.asarray(a, jnp.int32)
    return jnp.asarray(a)


def tf(a):
    """numpy → torch on the CPU, floats float32 and ints int32."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.as_tensor(a).clone()


def port(jax_obj, cls):
    """The port's dataclass ``cls`` holding the same values as the
    reference dataclass ``jax_obj``."""
    return convert.from_numpy(cls, convert.to_numpy(jax_obj), CPU)


def assert_same_fields(a, b, rtol=0.0, atol=0.0):
    """Every leaf of two dataclass trees (either package) agrees."""
    fa, fb = convert.to_numpy(a), convert.to_numpy(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), rtol=rtol,
                                       atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(x.astype(np.int64),
                                          y.astype(np.int64), err_msg=k)

