"""Index operations over a pose graph's vertex axis that the chain and PCG
bands share: per-graph gathers, and the marginal column solves' unit
right-hand sides and the read-back of their 3×3 blocks. They gather and
scatter only (the read-back also symmetrizes), so a band gets the same bits
through them as through a copy of its own.
"""

from __future__ import annotations

import torch


def pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0, or along axis 1 per graph of a batch
    (``idx [B, M]``)."""
    if idx.dim() == 1:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


def rows_of(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per graph: ``x [B, *C, N, 3]``, ``idx [B, M]``
    → ``[B, *C, M, 3]``."""
    mid = x.shape[1:-2]
    ix = idx.reshape((idx.shape[0],) + (1,) * len(mid) + (idx.shape[1], 1))
    return torch.gather(x, -2, ix.expand(x.shape[:-2] + (idx.shape[1],
                                                          x.shape[-1])))


def unit_columns(query: torch.Tensor, poses: torch.Tensor):
    """The ``3Q`` unit right-hand sides of the marginal column solves at
    the vertices ``query`` of the graph whose ``poses`` are given (``[N,
    3]`` with ``query [Q]``; a batch ``[B, N, 3]`` with ``query`` ``[Q]``,
    every graph, or ``[B, Q]``): ``(rhs [*B, 3Q, N, 3], rows [*B, 3Q])``,
    column ``3k + c`` the unit vector of vertex ``query[k]``, component
    ``c``, and ``rows`` each queried vertex three times."""
    n = poses.shape[-2]
    dev = poses.device
    q = query.expand(poses.shape[:-2] + query.shape[-1:]).long()
    rows = torch.repeat_interleave(q, 3, dim=-1)
    cs = torch.arange(3, device=dev).repeat(q.shape[-1])            # [3Q]
    rhs = ((torch.arange(n, device=dev)[:, None] == rows[..., None, None])
           & (torch.arange(3, device=dev) == cs[:, None, None]))
    return rhs.to(poses.dtype), rows


def marginal_blocks(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The 3×3 blocks ``[*B, Q, 3, 3]`` of the solves ``x [*B, 3Q, N, 3]``
    of :func:`unit_columns`' right-hand sides at its ``rows``, rows ×
    columns, symmetrized."""
    cols = torch.gather(x, -2, rows[..., None, None].expand(
        rows.shape + (1, 3)))[..., 0, :]                        # [*B,3Q,3]
    sig = cols.reshape(cols.shape[:-2] + (-1, 3, 3)).transpose(-1, -2)
    return 0.5 * (sig + sig.transpose(-1, -2))
