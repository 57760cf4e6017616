"""CPU tests of the PCG loop's vector updates (``ops/cg_update.py``), whose
CUDA kernels (``csrc/cg_update.cu``) cannot run here.

* The CG loop as ``solver/pcg.py:_masked_pcg`` runs it with the plain
  updates, against a literal transcription of the CG body it had before
  the kernels (one body, the four state selects, ``z`` in the state): bit
  for bit, in float32 and float64, for both ``done`` tests, with and
  without the jitter σ, with systems frozen from the start and systems
  freezing mid-loop (whose ``x`` stays bit for bit once frozen).
* :func:`rehearse_a` and :func:`rehearse_b` walk the kernels' arithmetic
  in numpy as the kernels do it (the plan's blocks: one a system, or a
  long system's chunks; each thread's items in order, each warp's shuffle
  tree, the warps in order, a split system's partials in order of
  chunk; every operation one IEEE rounding) and are held to the plain
  version, with padded items and a split system's ragged last chunk. The
  card tests hold the kernels to them bit for bit.
* The wrapper refuses CPU tensors and malformed inputs.
* ``masked_loop``'s capture-stream warm-up (``spd.first_use``) leaves an
  in-place body's state as it was.

This file imports neither JAX nor ``cg_mrslam_tpu``.
"""

import numpy as np
import pytest
import torch

from cg_mrslam_tpu_torch.ops import cg_update as CU
from cg_mrslam_tpu_torch.solver import pcg as P
from cg_mrslam_tpu_torch.solver import spd
from tools.bench_cg_update import update_inputs

torch.set_num_threads(1)


# ---- the CG body before the kernels, transcribed --------------------------

def _literal_pcg(hvp, precond, rhs, z0, free, budget, tol, new_residual,
                 jitter):
    """The CG loop as it was: ``hvp`` with the jitter added, one body
    computing every update for every system, the state selected by the
    fresh ``done`` test."""
    def hvp_j(x):
        return hvp(x) + jitter * x * CU.free_mask(free, x) if jitter \
            else hvp(x)

    def body(s):
        x, r, z, p, rz = s
        hp = hvp_j(p)
        alpha = rz / torch.clamp(CU.dot(p, hp), min=1e-30)
        x2 = x + spd.per(alpha, p) * p
        r2 = r - spd.per(alpha, hp) * hp
        z2 = precond(r2)
        rz2 = CU.dot(r2, z2)
        beta = rz2 / torch.clamp(rz, min=1e-30)
        p2 = z2 + spd.per(beta, p) * p
        rt = r2 if new_residual else r
        done = CU.dot(rt, rt) < tol
        new = (x2, r2, z2, p2, rz2)
        return tuple(torch.where(spd.per(done, o), o, nw)
                     for o, nw in zip(s, new)), ~done

    x, *_ = spd.masked_loop(body, (torch.zeros_like(rhs), rhs, z0, z0,
                                   CU.dot(rhs, z0)), budget, "test.literal")
    return x


def _problem(dtype, lead=(3, 4), n=7, seed=0, device="cpu"):
    """Small SPD systems ``[*lead, n, 3]`` over ``lead[0]`` graphs: per
    system ``A = M Mᵀ + c I`` on its free rows and columns (vertex 0 and
    one more of each graph not free), a diagonal preconditioner, and
    right-hand sides whose scales spread over six decades (so that
    systems freeze at different iterations); the first system of each
    graph has a zero right-hand side (frozen from the start). On
    ``device``."""
    rng = np.random.default_rng(seed)
    s, L = int(np.prod(lead)), 3 * n
    m = rng.normal(size=(s, L, L))
    c = 10.0 ** rng.uniform(-2, 1, size=(s, 1, 1))
    a = m @ np.swapaxes(m, -1, -2) / L + c * np.eye(L)
    free = np.ones((lead[0], n), bool)
    free[:, 0] = False
    free[np.arange(lead[0]), rng.integers(1, n, size=lead[0])] = False
    fe = np.repeat(free, 3, axis=-1)                       # [B, L]
    fe = np.broadcast_to(fe.reshape((lead[0],) + (1,) * (len(lead) - 1)
                                    + (L,)), lead + (L,)).reshape(s, L)
    a = a * fe[:, :, None] * fe[:, None, :]
    d = 1.0 / (np.einsum("sii->si", a) + 0.5 * rng.uniform(size=(s, L)))
    rhs = rng.normal(size=(s, L)) * 10.0 ** rng.uniform(-6, 0, size=(s, 1))
    rhs = rhs * fe
    rhs.reshape(lead + (L,))[(slice(None),) + (0,) * (len(lead) - 1)] = 0.0
    t = {k: torch.as_tensor(v, dtype=dtype, device=device) for k, v in
         (("a", a), ("d", d * fe), ("rhs", rhs))}
    shape = lead + (n, 3)
    free_t = torch.as_tensor(free, device=device)

    def hvp(p):
        return (t["a"] @ p.reshape(s, L, 1)).reshape(p.shape)

    def precond(r):
        return (t["d"] * r.reshape(s, L)).reshape(r.shape)

    return hvp, precond, t["rhs"].reshape(shape), free_t


@pytest.mark.parametrize("jitter", [0.0, 1e-6], ids=["plain", "jitter"])
@pytest.mark.parametrize("new_residual", [True, False],
                         ids=["new_residual", "old_residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_loop_matches_the_literal_body(dtype, new_residual, jitter):
    """``_masked_pcg`` with the plain updates gives the literal body's
    ``x`` bit for bit, at a budget the looks stop and one they do not; the
    systems freeze at several iterations, some at the first."""
    hvp, precond, rhs, free = _problem(dtype)
    tol = 1e-9 if dtype == torch.float32 else 1e-14
    for budget in (13, 64):
        want = _literal_pcg(hvp, precond, rhs, precond(rhs), free, budget,
                            tol, new_residual, jitter)
        got = P._masked_pcg(hvp, precond, rhs, precond(rhs), free, budget,
                            tol, "test.plain", "test", False, new_residual,
                            jitter)
        assert torch.equal(got, want), budget
    # the freeze pattern the comparison covers, and frozen systems'
    # state held bit for bit
    x, r = torch.zeros_like(rhs), rhs.clone()
    p = precond(rhs)
    rz = CU.dot(rhs, p)
    active = torch.ones(rz.shape, dtype=torch.bool)
    froze = torch.full(rz.shape, -1)
    for k in range(64):
        was, x_was = active, x
        x, r, active = CU.update_a_plain(x, r, p, hvp(p), rz, active, free,
                                         jitter, tol, new_residual)
        p, rz = CU.update_b_plain(r, precond(r), p, rz, active)
        froze[was & ~active] = k
        assert torch.equal(x[~was], x_was[~was])
    stops = set(froze.flatten().tolist())
    assert 0 in stops and len(stops - {-1}) >= 3, stops


# ---- the kernels' arithmetic, rehearsed -----------------------------------

W = CU.THREADS // 32


def _np(t):
    return t.detach().cpu().numpy()


def _layout(v, pl):
    """``[S, L]`` → the kernel's ``[S, G, items, threads]``: chunk ``g``,
    element ``g·CH + k·threads + t``; past ``L`` zero (never used)."""
    s, L = v.shape
    ch = CU.THREADS * pl.items
    out = np.zeros((s, pl.chunks * ch), v.dtype)
    out[:, :L] = v
    return out.reshape(s, pl.chunks, pl.items, CU.THREADS)


def _thread_sums(prod, inside):
    """Each thread's sum of its items in order of k (a padded item is
    skipped, not added)."""
    acc = np.zeros(prod.shape[:2] + prod.shape[3:], prod.dtype)
    for k in range(prod.shape[2]):
        acc = np.where(inside[:, :, k], acc + prod[:, :, k], acc)
    return acc


def _block_sums(acc):
    """``[S, G, threads]`` → ``[S, G]``: each warp by the shuffle tree
    (lane l adds lane l + o for o = 16 … 1; lane 0's total), then the
    warps in order."""
    w = acc.reshape(acc.shape[:2] + (W, 32)).copy()
    for o in (16, 8, 4, 2, 1):
        w[..., :o] = w[..., :o] + w[..., o:2 * o]
    tot = w[..., 0, 0]
    for j in range(1, W):
        tot = tot + w[..., j, 0]
    return tot


def _ordered(part):
    """``[S, G]`` → ``[S]``: a split system's partials in order of g."""
    tot = part[:, 0]
    for g in range(1, part.shape[1]):
        tot = tot + part[:, g]
    return tot


def _dot_k(a, b, inside):
    return _ordered(_block_sums(_thread_sums(a * b, inside)))


def _floor30(v):
    lo = v.dtype.type(CU.FLOOR)
    return np.where(v < lo, lo, v)


def _flat(t):
    n = t.shape[-2]
    return _np(t).reshape(-1, 3 * n)


def rehearse_a(x, r, p, hp, rz, active, free, sigma, tol, new_residual):
    """Update A as the kernels compute it: new ``(x, r, active)``."""
    shape, n = x.shape, x.shape[-2]
    L = 3 * n
    pl = CU.plan(L)
    X, R, Pv, H = (_layout(_flat(t), pl) for t in (x, r, p, hp))
    s = X.shape[0]
    dt = X.dtype.type
    idx = _layout(np.broadcast_to(np.arange(L), (s, L)), pl)
    inside = _layout(np.ones((s, L), bool), pl)
    if sigma:
        fr = _np(free).reshape(-1, n)
        graph = np.arange(s) // max(s // fr.shape[0], 1)
        F = fr[graph[:, None, None, None], idx // 3].astype(X.dtype)
        H = np.where(inside, H + (dt(sigma) * Pv) * F, H)
    rzv = _np(rz).reshape(s)
    act = _np(active).reshape(s)
    alpha = (rzv / _floor30(_dot_k(Pv, H, inside)))[:, None, None, None]
    R2 = R - alpha * H
    test = _dot_k(R2, R2, inside) if new_residual else _dot_k(R, R, inside)
    take = act & ~(test < dt(tol))
    tk = take[:, None, None, None]
    Xn, Rn = np.where(tk, X + alpha * Pv, X), np.where(tk, R2, R)

    def back(v):
        return torch.as_tensor(v.reshape(s, -1)[:, :L].reshape(shape))

    return back(Xn), back(Rn), torch.as_tensor(take.reshape(rz.shape))


def rehearse_b(r, z, p, rz, active):
    """Update B as the kernels compute it: new ``(p, rz)``."""
    shape, n = r.shape, r.shape[-2]
    L = 3 * n
    pl = CU.plan(L)
    R, Z, Pv = (_layout(_flat(t), pl) for t in (r, z, p))
    s = R.shape[0]
    inside = _layout(np.ones((s, L), bool), pl)
    rzv = _np(rz).reshape(s)
    act = _np(active).reshape(s)
    rz2 = _dot_k(R, Z, inside)
    beta = (rz2 / _floor30(rzv))[:, None, None, None]
    Pn = np.where(act[:, None, None, None], Z + beta * Pv, Pv)
    return (torch.as_tensor(Pn.reshape(s, -1)[:, :L].reshape(shape)),
            torch.as_tensor(np.where(act, rz2, rzv).reshape(rz.shape)))


def _close(got, want, rel):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= rel * scale


REHEARSALS = [((3, 5), 37, None), ((16,), 1024, None), ((16,), 64, 16),
              ((), 3000, None), ((2, 2), 1500, None)]


@pytest.mark.parametrize("lead,n,graphs", REHEARSALS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rehearsal_matches_plain(lead, n, graphs, dtype):
    """One block a system (items 8 with most of them padding; items 12 at
    1024 slots; a batch of graphs, one system each) and a split system
    (3000 and 1500 poses: chunks of 3072 floats, the last ragged): the
    same ``done`` flags, frozen systems untouched bit for bit, the rest
    within the sums' rounding."""
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    pl = CU.plan(3 * n)
    assert (pl.chunks > 1) == (3 * n > CU.CHUNK)
    for new_residual in (True, False):
        for sigma in (0.0, 1e-6):
            t, tol = update_inputs(lead, n, dtype, graphs=graphs)
            args = (t["x"], t["r"], t["p"], t["hp"], t["rz"], t["active"],
                    t["free"], sigma, tol, new_residual)
            want = CU.update_a_plain(*args)
            got = rehearse_a(*args)
            assert torch.equal(got[2], want[2])
            if t["rz"].numel() >= 4:      # every case of the done tests
                assert bool(want[2].any())
                assert bool((~want[2] & t["active"]).any())
            for g, w, before in zip(got[:2], want[:2], (t["x"], t["r"])):
                _close(g, w, rel)
                keep = ~want[2]
                assert torch.equal(g[keep], before[keep])
            pb = CU.update_b_plain(t["r"], t["z"], t["p"], t["rz"],
                                   want[2])
            gb = rehearse_b(t["r"], t["z"], t["p"], t["rz"], want[2])
            for g, w in zip(gb, pb):
                _close(g, w, rel)
            frozen = ~want[2]
            assert torch.equal(gb[0][frozen], t["p"][frozen])
            assert torch.equal(gb[1][frozen], t["rz"][frozen])


def test_plan_adapts_to_the_system_length():
    assert CU.plan(3 * 1024) == CU.Plan(12, 1)
    assert CU.plan(3 * 512) == CU.Plan(8, 1)
    assert CU.plan(3) == CU.Plan(8, 1)
    assert CU.plan(CU.CHUNK) == CU.Plan(12, 1)
    assert CU.plan(CU.CHUNK + 1) == CU.Plan(12, 2)
    assert CU.plan(3 * 65536) == CU.Plan(12, 64)


@pytest.mark.parametrize("wrong", [None, "alpha", "beta", "frozen"])
def test_card_check_passes_the_rehearsal_and_fails_a_wrong_update(
        monkeypatch, wrong):
    """``tools/bench_cg_update.check`` (the card tests' and ``chip_smoke``
    13 (j)'s check of the kernels) with the rehearsal standing in for the
    kernels, in place as they are: it passes, and it fails an update whose
    α or β is off by 1e-4 of itself or that writes a frozen system."""
    from tools import bench_cg_update as B

    def fake_a(x, r, p, hp, rz, active, free, sigma, tol, new_residual):
        nx, nr, na = rehearse_a(x, r, p, hp, rz, active, free, sigma, tol,
                                new_residual)
        if wrong == "alpha":
            nx = x + (nx - x) * (1 + 1e-4)
        if wrong == "frozen":
            nx = nx + 1e-3 * (~active)[..., None, None]
        x.copy_(nx), r.copy_(nr), active.copy_(na)
        CU.CG_UPDATE.launches += 1
        return x, r, active

    def fake_b(r, z, p, rz, active):
        np_, nrz = rehearse_b(r, z, p, rz, active)
        if wrong == "beta":
            np_ = z + (np_ - z) * (1 + 1e-4)
        p.copy_(np_), rz.copy_(nrz)
        CU.CG_UPDATE.launches += 1
        return p, rz

    monkeypatch.setattr(CU, "cg_update_a", fake_a)
    monkeypatch.setattr(CU, "cg_update_b", fake_b)
    monkeypatch.setattr(CU.CG_UPDATE, "launches", 0)
    for lead, n in (((4, 3), 40), ((4,), 1500)):
        for dtype in (torch.float32, torch.float64):
            if wrong is None:
                got = B.check(lead, n, dtype, 7, rehearse=..., device="cpu")
                assert got["froze"] > 0
            else:
                with pytest.raises(AssertionError):
                    B.check(lead, n, dtype, 7, device="cpu")


# ---- the wrapper's checks --------------------------------------------------

def test_wrapper_refuses_cpu_and_malformed_inputs(monkeypatch):
    t, tol = update_inputs((4, 3), 8, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        CU.CG_UPDATE.update_a(t["x"], t["r"], t["p"], t["hp"], t["rz"],
                              t["active"], t["free"], 1e-6, tol, True)
    with pytest.raises(ValueError, match="CUDA"):
        CU.CG_UPDATE.update_b(t["r"], t["z"], t["p"], t["rz"], t["active"])
    assert CU.CG_UPDATE.launches == 0

    # past the device test, the shapes, types and layouts
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))

    def check(**over):
        v = {k: over.get(k, t[k]) for k in ("x", "r", "p", "hp")}
        return CU.check_inputs(v, over.get("rz", t["rz"]),
                               over.get("active", t["active"]),
                               over.get("free", t["free"]))

    assert check() == CU.Sizes(12, 24, 3, 8)
    assert CU.check_inputs({"x": t["x"]}, t["rz"], t["active"], None) \
        == CU.Sizes(12, 24, 12, 8)
    bad = {
        "x": t["x"].double(),
        "r": t["r"][..., :2],
        "p": t["p"].transpose(0, 1).contiguous().transpose(0, 1),
        "hp": t["hp"].half(),
        "rz": t["rz"][:, :2],
        "active": t["active"].int(),
        "free": t["free"][:, :5],
    }
    for k, v in bad.items():
        with pytest.raises(ValueError):
            check(**{k: v})
    with pytest.raises(ValueError):
        check(free=t["free"].float())
    with pytest.raises(ValueError):
        check(free=t["free"][:2])
    with pytest.raises(ValueError, match="float32 or float64"):
        CU.check_inputs({"x": t["x"].half()}, t["rz"].half(), t["active"],
                        None)
    with pytest.raises(ValueError):
        CU.check_inputs({"x": t["x"][..., 0]}, t["rz"], t["active"], None)


# ---- masked_loop's warm-up --------------------------------------------------

def test_first_use_leaves_an_in_place_body_unadvanced():
    """The capture stream's first use runs the body on a copy: a body
    that writes its state in place leaves the loop's state as it was,
    and the copy took the step."""
    seen = []

    def body(s):
        k, x = s
        k += 1
        x.mul_(0.5).add_(1.0)
        seen.append((k, x))
        return (k, x), x > 0

    k0 = torch.zeros((), dtype=torch.long)
    x0 = torch.linspace(-1.0, 1.0, 5)
    want = (k0.clone(), x0.clone())
    spd.first_use(body, (k0, x0))
    assert torch.equal(k0, want[0]) and torch.equal(x0, want[1])
    assert int(seen[0][0]) == 1 and seen[0][1] is not x0
    assert torch.equal(seen[0][1], 0.5 * want[1] + 1.0)
