"""The cyclic-reduction preconditioner's compact factor and solve on the
CPU (``ops/cr_apply.py``), and a rehearsal of its CUDA kernel
(``csrc/cr_apply.cu``), which cannot run here.

* The structural claim the compact factor rests on, on random SPD chains
  in float64 (n a multiple of 16 and not, a super-block count a power of
  two and not, batch-1 and batched): every level's ``Le``, ``Lo``, ``A``,
  ``B`` that ``solver/cyclic_reduction.cr_factor`` computes is exactly
  zero outside the rows and corners it keeps, and the packed factor's
  views give back the kept entries bit for bit.
* The plain solve over the compact factor against a dense oracle kept
  here (the solve over the dense blocks the factorization computed, as
  the solver ran it before the factor was compact): bit for bit, since
  the plain version rebuilds those blocks exactly; and against the JAX
  package's ``_cr_solve``: 1e-12 of the answer's scale in float64; in
  float32 at the bar ``test_torch_solver_bands.py::
  test_cr_solve_and_chain_delta`` holds the port's solve to.
* :func:`_rehearsal` walks the kernel's exact inputs as the kernel does
  (the packed factor as one flat buffer, a block per graph and tile of
  columns, its buffer of ``m`` super-blocks per column at a pitch of 49,
  the level loops in the kernel's index arithmetic, ``r`` and ``z`` at
  their strides, the ``free`` masks on read and on write) and is held to
  the plain version, at every tile, with padded poses and super-blocks,
  on ``[B, C, N, 3]`` strided and column-last inputs.
* The inputs the solvers hand the kernel pass the wrapper's checks, and
  the wrapper refuses CPU tensors and malformed inputs.

This file imports the JAX package for the one comparison with its
``_cr_solve``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cg_mrslam_tpu.solver import chain as JCH
from cg_mrslam_tpu_torch.ops import cr_apply as CA
from cg_mrslam_tpu_torch.sim import graphs as GR
from cg_mrslam_tpu_torch.solver import chain as CH
from cg_mrslam_tpu_torch.solver import cyclic_reduction as CR
from cg_mrslam_tpu_torch.solver import pcg as P

torch.set_num_threads(1)

BB = 3 * CR.GROUP


def _chain(rng, shape, n):
    """A random SPD block-tridiagonal chain of ``n`` poses (``shape`` the
    batch's, or ()): diagonal blocks, couplings ``L[k] = T[k+1, k]``."""
    a = rng.normal(size=shape + (n, 3, 3))
    d = a @ np.swapaxes(a, -1, -2) + 4.0 * np.eye(3)
    low = 0.3 * rng.normal(size=shape + (n, 3, 3))
    low[..., -1, :, :] = 0.0
    return d, low


def _captured_factor(d, low, monkeypatch):
    """``cr_factor`` of the chain, with the dense blocks it hands the
    packer each level (``[P, *lead, bb, bb]``) and its root inverse."""
    seen, root = [], []
    pack_level, pack_root = CA.pack_level, CA.pack_root

    def keep_level(fact, level, *blocks):
        seen.append(tuple(x.clone() for x in blocks))
        return pack_level(fact, level, *blocks)

    def keep_root(fact, root_inv):
        root.append(root_inv.clone())
        return pack_root(fact, root_inv)

    monkeypatch.setattr(CA, "pack_level", keep_level)
    monkeypatch.setattr(CA, "pack_root", keep_root)
    fact = CR.cr_factor(torch.as_tensor(d), torch.as_tensor(low))
    monkeypatch.setattr(CA, "pack_level", pack_level)
    monkeypatch.setattr(CA, "pack_root", pack_root)
    return fact, seen, root[0]


# (poses, batch): 64 = 4 super-blocks, 96 = 6 (not a power of two), 70
# and 33 not multiples of 16, 1020 the benchmark's 64 super-blocks, 16 one
CHAINS = [(64, None), (96, None), (70, None), (33, 2), (1020, 2), (16, 3),
          (96, 3)]


@pytest.mark.parametrize("n,batch", CHAINS)
def test_dense_levels_are_zero_outside_the_kept_entries(n, batch,
                                                         monkeypatch):
    rng = np.random.default_rng(n)
    d, low = _chain(rng, () if batch is None else (batch,), n)
    fact, seen, root = _captured_factor(d, low, monkeypatch)
    assert len(seen) == CA.levels(fact.m)
    assert not seen or bool((seen[0][1] != 0).any())   # the claim is not empty
    for level, (doi, le, lo, a, b) in enumerate(seen):
        for name, x, rows, cols in (("Le", le, slice(0, 3), slice(BB - 3, BB)),
                                    ("Lo", lo, slice(0, 3), slice(BB - 3, BB)),
                                    ("A", a, slice(0, 3), slice(None)),
                                    ("B", b, slice(BB - 3, BB), slice(None))):
            rest = x.clone()
            rest[..., rows, cols] = 0.0
            assert bool((rest == 0).all()), (level, name)
        # the packed views give the kept entries back exactly
        kept = CA.level_views(fact, level)
        lead = (lambda x: x.reshape((x.shape[0], -1) + x.shape[-2:])
                .movedim(0, 1))                           # [B, P, ...]
        want = (lead(doi), lead(a)[..., 0:3, :], lead(b)[..., BB - 3:, :],
                lead(le)[..., 0:3, BB - 3:], lead(lo)[..., 0:3, BB - 3:])
        for got, w in zip(kept, want):
            assert torch.equal(got, w), level
    assert torch.equal(CA.root_view(fact), root.reshape(-1, BB, BB))


def _dense_apply(levels, root_inv, m, n3, rhs):
    """The solve over every level's dense blocks (``[P, *lead, bb, bb]``,
    as the factorization computes them) for ``rhs [*lead, n, 3, R]``:
    forward reduction, root, back-substitution, every product with the
    blocks' zeros included, each subtraction fused into its product as a
    ``baddbmm``."""
    batched = rhs.dim() == 4
    if batched:
        rhs = rhs.movedim(1, 0)                          # [n3, B, 3, R]
    lead, r_cols = rhs.shape[1:-2], rhs.shape[-1]
    group = BB // 3
    pad = torch.zeros((m * group - n3,) + rhs.shape[1:], dtype=rhs.dtype)
    rhs = torch.cat([rhs, pad]).reshape((m, group) + lead + (3, r_cols))
    rhs = rhs.movedim(1, -3).reshape((m,) + lead + (BB, r_cols))
    zero = torch.zeros_like(rhs[:1])

    def sub_mm(c, a, b):                                 # c − a @ b
        flat = c.dim() == 4
        out = torch.baddbmm(*(t.flatten(0, 1) if flat else t
                              for t in (c, a, b)), alpha=-1.0)
        return out.unflatten(0, c.shape[:2]) if flat else out

    stack = []
    for (doi, le, lo, a, b) in levels:
        re, ro = rhs[0::2], rhs[1::2]
        ro_prev = torch.cat([zero, ro[:-1]])
        rhs = sub_mm(sub_mm(re, a, ro_prev), b, ro)
        stack.append((doi, le, lo, ro))
    x = root_inv[None] @ rhs
    for (doi, le, lo, ro) in reversed(stack):
        x_next = torch.cat([x[1:], zero])
        xo = doi @ sub_mm(sub_mm(ro, le, x), lo.transpose(-1, -2), x_next)
        x = torch.stack([x, xo], dim=1).reshape((2 * x.shape[0],)
                                                 + x.shape[1:])
    x = x.reshape((m,) + lead + (group, 3, r_cols)).movedim(-3, 1)
    x = x.reshape((m * group,) + lead + (3, r_cols))[:n3]
    return x.movedim(0, 1) if batched else x


@pytest.mark.parametrize("n,batch", CHAINS)
def test_compact_solve_matches_the_dense_oracle(n, batch, monkeypatch):
    rng = np.random.default_rng(100 + n)
    shape = () if batch is None else (batch,)
    d, low = _chain(rng, shape, n)
    rhs = torch.as_tensor(rng.normal(size=shape + (n, 3, 5)))
    fact, seen, root = _captured_factor(d, low, monkeypatch)
    got = CR.cr_apply(fact, rhs)
    want = _dense_apply(seen, root, fact.m, n, rhs)
    assert got.shape == rhs.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [70, 128, 33])
def test_compact_solve_matches_the_jax_package(n, dtype):
    rng = np.random.default_rng(7 + n)
    d, low = (x.astype(dtype) for x in _chain(rng, (), n))
    rhs = rng.normal(size=(n, 3, 4)).astype(dtype)
    got = CR.cr_solve(torch.as_tensor(d), torch.as_tensor(low),
                      torch.as_tensor(rhs)).numpy()
    want = np.asarray(JCH._cr_solve(jnp.asarray(d), jnp.asarray(low),
                                    jnp.asarray(rhs)))
    if dtype == np.float64:
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    else:
        # test_cr_solve_and_chain_delta's bar
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _storage(t):
    """``t``'s storage from its first element to its last, flat, as the
    kernel addresses it (element strides from ``t.data_ptr()``)."""
    span = 1 + sum((k - 1) * st for k, st in zip(t.shape, t.stride()))
    return torch.as_strided(t, (span,), (1,)).numpy()


def _rehearsal(fact, r, free, tile):
    """The kernel, block by block over the flat buffers it is given: a
    block per (graph, tile of ``tile`` columns), its buffer ``v [tile, m ·
    49]`` (a super-block's 48 rows at a pitch of 49), each phase's
    threads vectorized (within a phase, and within a barrier interval of
    whole pairs, no thread reads what another writes) and each dot product
    summed in the kernel's order."""
    b, c, n = CA.check_inputs(fact, r, free)
    m, pitch = fact.m, CA.PITCH
    F = fact.packed.shape[1]
    fac = fact.packed.numpy().reshape(-1)
    R = _storage(r)
    rb, rc, rn, rk = r.stride()
    fr = None if free is None else free.numpy().reshape(-1)
    dt = R.dtype
    z = np.full(b * c * n * 3, np.nan, dt)       # unwritten shows as NaN
    zb, zc, zn, zk = c * n * 3, n * 3, 3, 1
    vlen = m * pitch
    tiles = -(-c // tile)
    levels = CA.levels(m)

    def doi_at(p):
        return BB * BB * (m - 2 * p)

    def ab_at(p):
        return BB * BB * m + 6 * BB * (m - 2 * p)

    def corner_at(p):
        return BB * BB * m + 6 * BB * (m - 1) + 18 * (m - 2 * p)

    def is_free(pose):
        return np.ones(pose.shape, bool) if fr is None else \
            fr[bi * n + np.minimum(pose, n - 1)].astype(bool)

    def put(q, cc, vals):
        """z at rows ``q`` (48 a super-block) of tile column ``cc``."""
        pose = q // 3
        ok = (c0 + cc < c) & (pose < n)
        keep = is_free(pose)
        at = bi * zb + (c0 + cc) * zc + pose * zn + (q - 3 * pose) * zk
        z[at[ok]] = np.where(keep, vals, dt.type(0))[ok]

    def dot48(base, ld, xs):
        """Σ_j fac[base + j·ld] · xs[j], in order of j."""
        acc = np.zeros(np.broadcast(base, xs[0]).shape, dt)
        for j in range(BB):
            acc = acc + fac[base + j * ld] * xs[j]
        return acc

    for blk in range(b * tiles):
        bi, c0 = blk // tiles, (blk % tiles) * tile
        f0 = bi * F
        v = np.full(tile * vlen, np.nan, dt)     # the pad rows stay NaN
        # load: i = col · m·48 + q, pose q / 3, component q % 3
        i = np.arange(m * BB * tile)
        cc, q = i // (m * BB), i % (m * BB)
        pose, k = q // 3, q % 3
        ok = (c0 + cc < c) & (pose < n) & is_free(pose)
        at = bi * rb + (c0 + cc) * rc + pose * rn + k * rk
        v[cc * vlen + q // BB * pitch + q % BB] = np.where(
            ok, R[np.where(ok, at, 0)], dt.type(0))
        for lv in range(levels):
            s, p = 1 << lv, m >> (lv + 1)
            it = np.arange(6 * p)
            t, kk = it // 6, it % 6
            live = ~((kk < 3) & (t == 0))
            it, t, kk = it[live], t[live], kk[live]
            src = np.where(kk < 3, 2 * t - 1, 2 * t + 1) * s * pitch
            dst = 2 * t * s * pitch + np.where(kk < 3, kk, BB - 6 + kk)
            for col in range(tile):
                acc = dot48(f0 + ab_at(p) + it, 6 * p,
                            [v[col * vlen + src + j] for j in range(BB)])
                v[col * vlen + dst] -= acc
        # the root, read whole before it is written
        r0 = np.arange(BB)
        x = [dot48(f0 + BB * BB * (m - 1) + r0, BB,
                   [v[col * vlen + j] for j in range(BB)])
             for col in range(tile)]
        for col in range(tile):
            v[col * vlen + r0] = x[col]
        for lv in reversed(range(levels)):
            s, p = 1 << lv, m >> (lv + 1)
            row = np.arange(p * BB)
            t, rr = row // BB, row % BB
            o = (2 * t + 1) * s
            le = f0 + corner_at(p) + 18 * t
            lo = le + 9
            nx = o + s < m
            out = []
            for col in range(tile):
                base = col * vlen
                xs = [v[base + o * pitch + j] for j in range(BB)]
                xp = base + (o - s) * pitch + BB - 3
                xn = base + np.where(nx, o + s, 0) * pitch
                for kk in range(3):
                    e = fac[le + 3 * kk] * v[xp]
                    e = e + fac[le + 3 * kk + 1] * v[xp + 1]
                    e = e + fac[le + 3 * kk + 2] * v[xp + 2]
                    xs[kk] = xs[kk] - e
                    u = fac[lo + kk] * v[xn]
                    u = u + fac[lo + 3 + kk] * v[xn + 1]
                    u = u + fac[lo + 6 + kk] * v[xn + 2]
                    xs[BB - 3 + kk] = np.where(nx, xs[BB - 3 + kk] - u,
                                               xs[BB - 3 + kk])
                y = dot48(f0 + doi_at(p) + t * BB + rr, p * BB, xs)
                if lv == 0:
                    put(o * BB + rr, col, y)
                out.append(y)
            if lv > 0:
                for col in range(tile):
                    v[col * vlen + o * pitch + rr] = out[col]
        e = np.arange((m + 1) // 2 * BB)
        t, rr = e // BB, e % BB
        for col in range(tile):
            put(2 * t * BB + rr, col, v[col * vlen + 2 * t * pitch + rr])
    return torch.as_tensor(z.reshape(b, c, n, 3))


def _layouts(rng, b, c, n, dtype):
    """``r [B, C, N, 3]`` contiguous, strided (every other column of a
    wider tensor) and column-last (a ``[B, N, 3, C]`` tensor's view)."""
    x = torch.as_tensor(rng.normal(size=(b, c, n, 3)), dtype=dtype)
    wide = torch.zeros((b, 2 * c, n, 3), dtype=dtype)
    wide[:, ::2] = x
    last = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    return {"contiguous": x, "strided": wide[:, ::2], "column-last": last}


REHEARSALS = [(70, 2, 3, 1), (96, 1, 5, 2), (33, 3, 9, 2), (128, 2, 3, 2),
              (16, 2, 1, 1)]


@pytest.mark.parametrize("n,b,c,tile", REHEARSALS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rehearsal_matches_plain(n, b, c, tile, dtype):
    rng = np.random.default_rng(n + c)
    d, low = _chain(rng, (b,), n)
    fact = CR.cr_factor(torch.as_tensor(d, dtype=dtype),
                        torch.as_tensor(low, dtype=dtype))
    free = torch.as_tensor(rng.uniform(size=(b, n)) > 0.2)
    free[:, 0] = False
    for name, r in _layouts(rng, b, c, n, dtype).items():
        for fr in (None, free):
            want = CA.cr_apply_plain(fact, r, fr)
            got = _rehearsal(fact, r, fr, tile)
            assert bool(torch.isfinite(got).all()), name
            scale = float(want.abs().max())
            bar = 1e-12 if dtype == torch.float64 else 2e-5
            assert float((got - want).abs().max()) <= bar * scale, name
            if fr is not None:
                frozen = ~fr[:, None, :, None].expand_as(got)
                assert bool((got[frozen] == 0).all())
                assert bool((want[frozen] == 0).all())


def test_solve_masks_frozen_rows_on_read_and_write():
    """A frozen vertex's residual is not read (whatever it holds) and its
    rows come back zero; the free rows equal a solve of the residual
    with the frozen rows zeroed."""
    rng = np.random.default_rng(3)
    d, low = _chain(rng, (2,), 40)
    fact = CR.cr_factor(torch.as_tensor(d), torch.as_tensor(low))
    free = torch.ones((2, 40), dtype=torch.bool)
    free[0, 5] = free[1, 39] = False
    r = torch.as_tensor(rng.normal(size=(2, 3, 40, 3)))
    noisy = r.clone()
    noisy[~free[:, None, :].expand(2, 3, 40)] = 1e6
    zeroed = torch.where(free[:, None, :, None], r, 0.0)
    got = CR.cr_apply_cols(fact, noisy, free)
    want = CA.cr_apply_plain(fact, zeroed)
    want = torch.where(free[:, None, :, None], want, 0.0)
    assert torch.equal(got, want)


def _one(g, k=0):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name)[k]
                                     for f in dataclasses.fields(g)})


def test_kernel_inputs_pass_the_wrappers_checks(monkeypatch):
    """What the solvers hand the solve on every call: batched and batch-1
    PCG solves and marginal solves of the merged graph under its chain
    order, and the chain band's Woodbury solve (its ``HinvU`` columns
    last, its CG state's columns first)."""
    g, order, _ = GR.build_merged_batch(2, device="cpu")
    plain = CA.cr_apply_plain
    seen = []

    def checked(fact, r, free=None):
        seen.append(CA.check_inputs(fact, r, free))
        return plain(fact, r, free)

    monkeypatch.setattr(CA, "cr_apply_plain", checked)
    n = g.poses.shape[-2]
    q = torch.tensor([100, 700])
    for gg in (g, _one(g)):
        b = 2 if gg.poses.dim() == 3 else 1
        del seen[:]
        P.optimize_pcg(gg, 1, cg_iters=8, order=order)
        assert seen and set(seen) == {(b, 1, n)}
        del seen[:]
        P.marginal_covariance_pcg(gg, q, cg_iters=8, order=order)
        assert seen and set(seen) == {(b, 6, n)}
    ring = GR.build_hospital_batch(2, n=64, closures=4, seed=2, device="cpu")
    for gg in (ring, _one(ring)):
        del seen[:]
        CH.optimize_chain(gg, 1, loop_cap=8)
        assert seen and all(s[2] == 64 for s in seen)


def test_plan_fits_the_card():
    """Every plan's block fits the card: its threads, its tile, its
    buffer in shared memory or in device memory."""
    limit, sms = 232448, 132
    for b, c, m in ((2048, 1, 64), (128, 384, 64), (1, 48, 64), (1, 1, 4096),
                    (4, 3, 8), (1, 1, 1), (2, 7, 256)):
        for size in (4, 8):
            p = CA.plan(b, c, m, size, limit, sms)
            assert p.tile in CA.TILES and p.tile <= max(c, 1)
            assert p.threads % 96 == 0 and 96 <= p.threads <= 384
            need = CA.buffer_elems(m, p.tile)
            if p.smem:
                assert p.smem == need * size <= limit and p.scratch == 0
            else:
                assert need * size > limit
                assert p.scratch == b * -(-c // p.tile) * need


def test_wrapper_refuses_cpu_and_malformed_inputs():
    rng = np.random.default_rng(5)
    d, low = _chain(rng, (2,), 40)
    fact = CR.cr_factor(torch.as_tensor(d, dtype=torch.float32),
                        torch.as_tensor(low, dtype=torch.float32))
    r = torch.zeros((2, 3, 40, 3))
    free = torch.ones((2, 40), dtype=torch.bool)
    before = CA.CR_APPLY.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        CA.CR_APPLY(fact, r, free)
    bad = {"r": (r[..., :2], "^r"), "dtype": (r.half(), "float32 or float64"),
           "poses": (torch.zeros((2, 3, 41, 3)), "^factor"),
           "batch": (torch.zeros((1, 3, 40, 3)), "^factor"),
           "double": (r.double(), "^factor")}
    for name, (rr, msg) in bad.items():
        with pytest.raises(ValueError, match=msg):
            CA.check_inputs(fact, rr, free)
    for fr in (free.int(), free[:1], free.t().contiguous().t()[:, :40],
               torch.ones((2, 80), dtype=torch.bool)[:, ::2]):
        with pytest.raises(ValueError, match="^free"):
            CA.check_inputs(fact, r, fr)
    with pytest.raises(ValueError, match="group"):
        CA.check_inputs(dataclasses.replace(fact, group=8), r, free)
    with pytest.raises(ValueError, match="contiguous"):
        CA.check_inputs(dataclasses.replace(
            fact, packed=fact.packed.t().contiguous().t()), r, free)
    # a CPU solve takes the plain version
    CR.cr_apply_cols(fact, r, free)
    assert CA.CR_APPLY.launches == before
