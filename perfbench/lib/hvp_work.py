"""The bytes one Hessian-vector product of the PCG band needs.

A copy of the program's count (``cg_mrslam_tpu_torch/utils/cuda_timing.py``
``hvp_work``), kept here so that the yardstick cannot move with the
program: the function's own inputs, each read once (Jᵢ, Jⱼ, Ω, the
edges' int32 ends, ``x``, the int32 compressed rows' listed entries and
offsets, the bool ``free``), and ``y`` written once. The two-pass
kernels' intermediate (a 3-vector per edge end and column) is left out,
so the count is a lower bound of what a call moves.
"""

from __future__ import annotations


def hvp_bytes(b: int, c: int, n: int, e: int, listed: int,
              itemsize: int = 4) -> int:
    """Bytes of one product over ``b`` graphs, ``c`` columns, ``n`` vertex
    and ``e`` edge slots with ``listed`` active edge ends in all."""
    s = itemsize
    return (3 * b * e * 9 * s + b * e * 2 * 4 + 2 * b * c * n * 3 * s
            + listed * 4 + (b * n + 1) * 4 + b * n)
