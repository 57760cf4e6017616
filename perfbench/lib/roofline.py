"""Published peaks of the card, and the work a solve's inputs need.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit (a card set below it runs slower; every run prints
its limit). Keyed by a part of the name ``torch.cuda.get_device_name``
gives; a card not listed has no roofline, and its readers report nothing.

Work: the least a Gauss–Newton solve of the dense band needs, counted from
the live graph (its poses and edges), whatever the program pads, assembles
or reads again.
"""

from __future__ import annotations

PEAKS = {
    # float32 outside the tensor cores (TF32 off), and HBM3
    "H100": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}

# per live edge and GN iteration: Jᵢᵀ Ω and Jⱼᵀ Ω (2 × 27 multiply-adds),
# JᵢᵀΩJᵢ, JᵢᵀΩJⱼ, JⱼᵀΩJⱼ (3 × 27), JᵢᵀΩe and JⱼᵀΩe (2 × 9): 153
# multiply-adds, 306 flops
EDGE_BLOCK_FLOPS = 306
# bytes of one graph's inputs and output: a pose is 3 float32, a vertex
# also carries two flags; an edge two int32 ends, a float32 measurement
# (3) and packed information (6), and a flag
POSE_BYTES = 12
VERTEX_FLAG_BYTES = 2
EDGE_BYTES = 8 + 12 + 24 + 1


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def dense_gn_flops(poses: int, edges: int, iterations: int) -> float:
    """Per GN iteration: the Cholesky factorization of the ``3N`` system,
    ``(3N)³/3``, its two triangular solves, ``2·(3N)²``, and the block
    products of the live edges."""
    m = 3 * poses
    return iterations * (m ** 3 / 3 + 2 * m ** 2 + EDGE_BLOCK_FLOPS * edges)


def graph_bytes(poses: int, edges: int) -> float:
    """Each input read once (poses, vertex flags, edges) and each output
    (the poses) written once."""
    return (poses * (POSE_BYTES + VERTEX_FLAG_BYTES) + edges * EDGE_BYTES
            + poses * POSE_BYTES)


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    return max(flops / peak["fp32_flops"], nbytes / peak["hbm_bytes"])
