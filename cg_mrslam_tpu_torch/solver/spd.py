"""SPD inverse as batched matmuls, and a dense PCG polish.

Port of ``cg_mrslam_tpu/solver/spd.py``: the explicit inverse of a batched
SPD matrix by recursive 2×2 block-Schur inversion down to ≤24×24 blocks
(inverted by unpivoted Gauss–Jordan), Jacobi-equilibrated and polished by
Newton–Schulz with a restart from the guaranteed-convergent seed
``I/‖H‖∞``; :func:`pcg_refine` solves ``H X = B`` by dense CG with that
inverse as preconditioner and warm start. The reference's
``chol=False`` solver path (``solver/gauss_newton.py``), the chain
band's Woodbury capacitance solve and the cyclic reduction's super-block
inverses (``solver/cyclic_reduction.py``) are built on these.

The reference's ``lax.while_loop`` tolerance exits become loops over the
static budget in which a ``done`` flag freezes the state: the same
iterates, and no host read per iteration. Every :data:`CHECK` iterations
the host looks once whether anything is still running and stops early
when nothing is (:func:`masked_loop`).

Over a batch of independent problems (``batch_dims`` leading axes, the
reference's ``vmap``), each problem keeps its own exit: its own worst
residual decides when it stops, and a stopped problem stays frozen while
the others run on. The host still looks once every :data:`CHECK`
iterations, whatever the batch size.

On the card a loop whose iterations are too small to keep the device busy
can run its stretches between looks as one captured CUDA graph
(``masked_loop(..., graph=True)``): the first stretch runs as written,
the next is captured once and replayed for the rest, so the host launches
one graph a look instead of every kernel of :data:`CHECK` iterations. The
kernels and their order are those of the plain loop. While a profiler
records, the loop runs as written, so that its spans keep their events.
"""

from __future__ import annotations

import torch

from cg_mrslam_tpu_torch.utils import metrics

_BASE = 24
# iterations between the host's looks at a masked loop's done flags
CHECK = 8


def masked_loop(body, state, budget: int, name: str, graph: bool = False):
    """``while cond(s): s = body(s)`` over at most ``budget`` iterations,
    with the condition folded into ``body``: ``body(state) -> (new_state,
    active)``, where ``active`` (a bool tensor broadcastable against each
    state leaf's leading dims) says which entries took the step. Entries
    that are not active keep their value — ``body`` applies the mask
    itself. ``state`` is a tuple of tensors. Returns the final state.

    Each look copies the active flags to the host (one read, no kernel)
    and counts them there. ``name`` keys the loop's counters in
    :mod:`utils.metrics`: ``loop.<name>.iters`` (iterations run),
    ``.looks``, ``.active`` (active entries summed over the looks),
    ``.problems`` (entries × looks), and ``host_read.<name>`` (its
    looks). With ``graph``, on CUDA tensors and while no profiler
    records, the stretches after the first replay one captured graph of
    :data:`CHECK` iterations (``body`` must be free of host reads). A
    ``body`` may write its state in place: it then writes the tensors
    handed in here."""
    looks = active_sum = problems = k = 0
    graph = graph and state[0].is_cuda and not metrics._profiling()
    stretch = None
    while k < budget:
        steps = min(CHECK, budget - k)
        if graph and stretch is None and k and steps == CHECK:
            stretch = _GraphedStretch(body, state, CHECK)
        if stretch is not None and steps == CHECK:
            state, active = stretch(state)
        else:
            for _ in range(steps):
                state, active = body(state)
        k += steps
        if k % CHECK == 0:
            n = int(active.cpu().sum())
            looks += 1
            active_sum += n
            problems += active.numel()
            if not n:
                break
    for key, v in (("iters", k), ("looks", looks), ("active", active_sum),
                   ("problems", problems)):
        metrics.count(f"loop.{name}.{key}", v)
    metrics.count(f"host_read.{name}", looks)
    return state


# a device's capture stream (one, so that its library workspaces are made
# once), the memory pool its captures share, and its last captured graph:
# kept until the next capture has begun, so that the pool stays open and
# the next capture reuses its memory (a graph is never replayed once its
# loop has ended)
_CAPTURE: dict = {}


def first_use(body, state) -> None:
    """One call of a :func:`masked_loop` body that advances nothing: on a
    copy of ``state``, so that a body that writes its state in place
    leaves the loop's state as it was (a capture stream's first use)."""
    body(tuple(s.clone() for s in state))


class _GraphedStretch:
    """``steps`` iterations of a :func:`masked_loop` body captured as one
    CUDA graph over a static copy of ``state``: a call copies the state in
    where it is not that copy already, replays the graph on the current
    stream and returns the static state (the last iteration's written
    back into it) and the last iteration's active flags."""

    def __init__(self, body, state, steps: int):
        dev = state[0].device
        main = torch.cuda.current_stream(dev)
        if dev not in _CAPTURE:
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):         # the stream's first use
                first_use(body, state)
            _CAPTURE[dev] = [side, torch.cuda.graph_pool_handle(), None]
        side, pool, _ = _CAPTURE[dev]
        self.static = tuple(s.clone() for s in state)
        self.graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=pool)
            cur = self.static
            for _ in range(steps):
                cur, active = body(cur)
            for dst, src in zip(self.static, cur):
                if dst is not src:                # not written in place
                    dst.copy_(src)
            self.graph.capture_end()
        main.wait_stream(side)
        _CAPTURE[dev][2] = self.graph
        self.active = active

    def __call__(self, state):
        if state is not self.static:
            for dst, src in zip(self.static, state):
                dst.copy_(src)
        self.graph.replay()
        return self.static, self.active


def _worst(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """The largest entry of ``x`` within each of its leading
    ``batch_dims`` axes' problems (over all of ``x`` when 0)."""
    if batch_dims == 0:
        return torch.amax(x)
    if x.dim() == batch_dims:
        return x
    return torch.amax(x.flatten(batch_dims), dim=-1)


def per(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-problem ``flag`` (its dims leading ``like``'s) shaped to
    broadcast against ``like``."""
    if flag.dim() == 0:
        return flag
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def _gauss_jordan_inverse(a: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD ``[..., n, n]`` (n ≤ ``_BASE``) by Gauss–Jordan
    without pivoting: n sequential vectorized elimination steps."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    off = 1.0 - eye                         # column k: 0 at row k, else 1
    m = torch.cat([a, eye.expand(a.shape)], dim=-1)     # [..., n, 2n]
    for k in range(n):
        piv = m[..., k, :] / m[..., k, k, None]
        col = m[..., :, k] * off[:, k]
        m = torch.addcmul(m, col[..., :, None], piv[..., None, :],
                          value=-1.0)
        m[..., k, :] = piv
    return m[..., :, n:]


def _spd_inverse_rec(h: torch.Tensor) -> torch.Tensor:
    n = h.shape[-1]
    if n <= _BASE:
        return _gauss_jordan_inverse(h)
    m = n // 2
    a = h[..., :m, :m]
    bt = h[..., :m, m:]
    b = h[..., m:, :m]
    c = h[..., m:, m:]

    ai = _spd_inverse_rec(a)
    ai_bt = ai @ bt                                      # A⁻¹Bᵀ
    s = c - b @ ai_bt                                    # Schur complement
    si = _spd_inverse_rec(s)

    tr = -(ai_bt @ si)                                   # top-right block
    tl = ai - tr @ ai_bt.transpose(-1, -2)
    out = torch.cat([torch.cat([tl, tr], dim=-1),
                     torch.cat([tr.transpose(-1, -2), si], dim=-1)], dim=-2)
    return 0.5 * (out + out.transpose(-1, -2))


def _fro(r: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(r * r, dim=(-2, -1)))


def spd_inverse(h: torch.Tensor, refine: int = 2, max_refine: int = 48,
                tol: float | None = None,
                batch_dims: int = 0) -> torch.Tensor:
    """Explicit inverse of a batched SPD matrix ``[..., n, n]``: the
    recursion on the Jacobi-equilibrated matrix, then Newton–Schulz
    ``X ← X + X(I − HX)`` until the worst batch element's Frobenius
    residual is ≤ ``tol`` (at least ``refine``, at most ``max_refine``
    steps). An element whose residual grows restarts from ``I/‖H‖∞``.
    The first ``batch_dims`` axes are independent problems, each with
    its own worst element and exit."""
    n = h.shape[-1]
    if tol is None:
        tol = 1e-4 if h.dtype == torch.float32 else 1e-11
    d = torch.rsqrt(torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1),
                                min=1e-30))                  # [..., n]
    hs = h * d[..., :, None] * d[..., None, :]
    x = _spd_inverse_rec(hs)
    eye = torch.eye(n, dtype=h.dtype, device=h.device)

    def resid(xc):
        r = eye - hs @ xc
        return r, _fro(r)

    r, rn = resid(x)
    inf_norm = torch.amax(torch.sum(torch.abs(hs), dim=-1), dim=-1)
    tau = torch.clamp(inf_norm, min=1.0)[..., None, None]
    seed = eye / tau
    r_seed = eye - hs / tau
    rn_seed = _fro(r_seed)
    inf = torch.full((), float("inf"), dtype=rn.dtype, device=rn.device)

    def body(s):
        k, xc, rc, rn_arr, prev_worst = s
        worst = _worst(rn_arr, batch_dims)
        improving = worst < 0.7 * prev_worst
        go = (k < refine) | ((k < max_refine) & (worst > tol)
                             & ((worst >= 0.25) | improving))
        xn = xc + xc @ rc
        xn = 0.5 * (xn + xn.transpose(-1, -2))
        r2, rn2 = resid(xn)
        diverged = ~(rn2 <= torch.clamp(rn_arr * 1.5, min=tol))
        dd = diverged[..., None, None]
        xn = torch.where(dd, seed, xn)
        r2 = torch.where(dd, r_seed, r2)
        rn2 = torch.where(diverged, rn_seed, rn2)
        return (torch.where(go, k + 1, k), torch.where(per(go, xc), xn, xc),
                torch.where(per(go, rc), r2, rc),
                torch.where(per(go, rn_arr), rn2, rn_arr),
                torch.where(go, worst, prev_worst)), go

    k0 = torch.zeros(h.shape[:batch_dims], dtype=torch.int32,
                     device=h.device)
    _, x, _, _, _ = masked_loop(body, (k0, x, r, rn, inf),
                                max(refine, max_refine), "spd.newton_schulz")
    return x * d[..., :, None] * d[..., None, :]


def pcg_refine(h: torch.Tensor, b: torch.Tensor, minv: torch.Tensor,
               max_iters: int = 64, tol: float = 1e-5,
               batch_dims: int = 0) -> torch.Tensor:
    """Solve ``H X = B`` (``b [..., n, R]``, R right-hand sides, each its
    own CG) by dense preconditioned CG with ``minv`` as preconditioner and
    warm start, until the worst relative residual is ≤ ``tol`` or
    ``max_iters``. Breakdown guards zero the step instead of dividing by
    ~0, so the result is finite for finite inputs. The first
    ``batch_dims`` axes are independent problems, each with its own worst
    residual and exit."""
    x = minv @ b
    r = b - h @ x
    z = minv @ r
    p = z
    rz = torch.sum(r * z, dim=-2)                        # [..., R]
    bn = torch.clamp(torch.sum(b * b, dim=-2), min=1e-30)

    def body(s):
        x, rr, p, rz = s
        rel = torch.sum(rr * rr, dim=-2) / bn
        go = _worst(rel, batch_dims) > tol * tol
        hp = h @ p
        denom = torch.sum(p * hp, dim=-2)
        ok = denom > 1e-30
        alpha = torch.where(ok, rz / torch.where(ok, denom,
                                                 torch.ones_like(denom)),
                            torch.zeros_like(denom))
        x2 = x + p * alpha[..., None, :]
        r2 = rr - hp * alpha[..., None, :]
        z2 = minv @ r2
        rz2 = torch.sum(r2 * z2, dim=-2)
        okb = torch.abs(rz) > 1e-30
        beta = torch.where(okb, rz2 / torch.where(okb, rz,
                                                  torch.ones_like(rz)),
                           torch.zeros_like(rz))
        p2 = z2 + p * beta[..., None, :]
        return (torch.where(per(go, x), x2, x),
                torch.where(per(go, rr), r2, rr),
                torch.where(per(go, p), p2, p),
                torch.where(per(go, rz), rz2, rz)), go

    x, _, _, _ = masked_loop(body, (x, r, p, rz), max_iters,
                             "spd.pcg_refine")
    return x
