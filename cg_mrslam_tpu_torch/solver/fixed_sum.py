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
host read.) The same lists in compressed-row form (:class:`Segments`'
``entries`` and ``offsets``) come with the table at no further cost: the
PCG band's Hessian-vector kernel walks them.

Integer sums (vertex degrees) stay ``index_add_``: they are exact in any
order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cg_mrslam_tpu_torch.utils.metrics import count


class Segments(NamedTuple):
    """The contributions that land on each row, in contribution order,
    twice: as a padded table and in compressed-row form."""

    table: torch.Tensor    # [n, width] int64, padded with K (a zero)
    entries: torch.Tensor  # [K] int64: row 0's entries, row 1's, ...,
    #                        then the inactive contributions
    offsets: torch.Tensor  # [n + 1] int64: row r's entries are
    #                        entries[offsets[r]:offsets[r + 1]]


def segment_table(targets: torch.Tensor, active: torch.Tensor,
                  n: int) -> Segments:
    """:class:`Segments` of ``K`` contributions onto ``n`` rows. The
    table's row ``r`` lists, in order, the active contributions ``k``
    (``active[k]``) with ``targets[k] == r``, then ``K`` (one past the
    last contribution: a zero) up to the width, the largest count; the
    compressed rows list the same entries in the same order. Reads the
    width on the host: build it once per solve."""
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
    count("host_read.segment_table")
    slot = torch.full((n + 1, width), k, dtype=torch.long, device=dev)
    # inactive contributions go to the spare row n (cut off below), all to
    # its first column
    slot[ts, torch.where(ts < n, rank, torch.zeros_like(rank))] = order
    return Segments(slot[:n], order, starts)


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
               n: int) -> Segments:
    """The :class:`Segments` of the ends ``[vi; vj]`` of the active edges:
    contribution ``k < E`` is edge ``k``'s ``i`` end, ``E + k`` its ``j``
    end. For a batch (``e_ij [B, E, 2]``, ``active [B, E]``) the rows are
    the flattened ``[B·N]`` vertices (graph ``b``'s at ``b·N ..``) and the
    contributions the flattened ``[2, B, E]`` ends (:func:`ends_sum`); one
    graph is the batch of one."""
    flat = e_ij.long().reshape(-1, e_ij.shape[-2], 2)
    b = flat.shape[0]
    flat = flat + n * torch.arange(b, device=e_ij.device)[:, None, None]
    act = active.reshape(-1)
    return segment_table(flat.permute(2, 0, 1).reshape(-1),
                         torch.cat([act, act]), b * n)


def ends_sum(table: torch.Tensor, at_i: torch.Tensor, at_j: torch.Tensor,
             batch_dims: int = 1) -> torch.Tensor:
    """Per vertex ``[*B, N, ...]``, the sum of the edges' ``i`` end
    contributions ``at_i [*B, E, ...]`` and ``j`` end contributions
    ``at_j`` through an :func:`edge_table`'s ``table`` (``batch_dims``
    leading batch axes, 0 or 1)."""
    lead = at_i.shape[:batch_dims]
    out = segment_sum(table, torch.cat([at_i.flatten(0, batch_dims),
                                        at_j.flatten(0, batch_dims)]))
    return out.unflatten(0, lead + (table.shape[0] // lead.numel(),))
