"""Scatter-adds whose summation order does not change from run to run.

``index_add_`` adds float32 values on the card with atomics, so two runs on
the same inputs can differ in the last bits wherever several values land on
one row; a near tie downstream of a solve can then flip. The chain and
PCG bands sum through a :func:`segment_table` instead: a table of the
contributions that land on each row, in contribution order, padded with a
zero to the largest count. A sum through it is one gather and one reduction
over the table's width, in one fixed order on every device, so a repeat on
the same inputs is bit-identical. The table is built once per solve (one
host read: its width) and reused by every CG iteration, since a solve's
edge set does not change. (The dense band and the chain band's loop edges
sum by one-hot products instead, the reference's form: static shapes, no
host read.)

Integer sums (vertex degrees) stay ``index_add_``: they are exact in any
order.
"""

from __future__ import annotations

import torch


def segment_table(targets: torch.Tensor, active: torch.Tensor,
                  n: int) -> torch.Tensor:
    """``[n, width]`` int64: row ``r`` lists, in order, the active
    contributions ``k`` (``active[k]``) with ``targets[k] == r``, then
    ``K`` (one past the last contribution: a zero) up to the width, the
    largest count. Reads the width on the host: build it once per
    solve."""
    k = targets.shape[0]
    dev = targets.device
    t = torch.where(active, targets.long(),
                    torch.full((k,), n, dtype=torch.long, device=dev))
    order = torch.argsort(t, stable=True)
    ts = t[order]
    counts = torch.zeros((n + 1,), dtype=torch.long, device=dev)
    counts.index_add_(0, t, torch.ones((k,), dtype=torch.long, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(k, device=dev) - starts[ts]
    width = max(int(counts[:n].max()), 1)
    slot = torch.full((n + 1, width), k, dtype=torch.long, device=dev)
    # inactive contributions go to the spare row n (cut off below), all to
    # its first column
    slot[ts, torch.where(ts < n, rank, torch.zeros_like(rank))] = order
    return slot[:n]


def segment_sum(table: torch.Tensor, vals: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """``out[..., r, ...] = Σ`` of the contributions ``vals[..., k, ...]``
    (``k`` along axis ``dim``) that ``table`` (:func:`segment_table`)
    lists on row ``r``, added in one fixed order (a reduction over the
    table's width)."""
    dim = dim % vals.dim()
    zero = vals.new_zeros(vals.shape[:dim] + (1,) + vals.shape[dim + 1:])
    ext = torch.cat([vals, zero], dim)
    n, width = table.shape
    picked = ext.index_select(dim, table.reshape(-1))
    return picked.reshape(vals.shape[:dim] + (n, width)
                          + vals.shape[dim + 1:]).sum(dim + 1)


def edge_table(e_ij: torch.Tensor, active: torch.Tensor,
               n: int) -> torch.Tensor:
    """The segment table of the ends ``[vi; vj]`` of the active edges:
    contribution ``k < E`` is edge ``k``'s ``i`` end, ``E + k`` its ``j``
    end."""
    return segment_table(e_ij.T.reshape(-1), torch.cat([active, active]), n)
