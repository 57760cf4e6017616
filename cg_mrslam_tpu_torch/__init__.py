"""PyTorch/CUDA port of ``cg_mrslam_tpu`` for NVIDIA Hopper.

The package mirrors ``cg_mrslam_tpu``'s module layout; plain tensor code is
PyTorch and the score-volume kernels K1 (contiguous window) and K2 (strided
lattice) are hand-written CUDA (``csrc/score_volume.cu``). It imports torch, numpy and the standard library
only.

Precision is pinned at import: the normal equations are assembled at
coordinate scales (~20 m lever arms x 1e4 information) where TF32's ten-bit
mantissa injects gradients that grow with distance from the origin — the
reference measured live runs diverging to NaN from exactly that
(``cg_mrslam_tpu/solver/gauss_newton.py``), so every float32 matmul here
runs in full float32.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. Raises when the card is asked for (explicitly or by default)
    and none is present — there is no quiet fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cg_mrslam_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
