"""The PCG band's Hessian-vector product on the CPU: the compressed rows
that the segment table carries, and a rehearsal of the CUDA kernel pair
(``csrc/pcg_hvp.cu``), which cannot run here.

* ``segment_table``'s compressed rows (``entries``, ``offsets``) list
  exactly each row's table entries, in table order, for one graph and a
  batch, with masked edges and a vertex of degree 0.
* :func:`_rehearsal` walks the kernel pair's exact inputs as the kernels
  do — the flat buffers, the thread index split into (graph, edge or
  vertex, column), the contribution index ``k`` (``b·E + e`` the ``i`` end,
  ``B·E + b·E + e`` the ``j`` end), the compressed rows, the ``[B, C, N,
  3]`` strides — in the kernels' order of operations, and is held to
  ``pcg._hvp_plain``: within 1e-12 in float64, and in float32 within 1e-5
  of each row's ``Σ|Jᵀ||Ω||J||x|`` (a term passes about twenty float32
  roundings of 2⁻²⁴ each, summed in another order, so ~1e-6 of that
  scale; 1e-5 leaves room, and is the card tests' bar too). Cases: one
  graph with 8 columns, a batch, a batch with columns, frozen vertices.
* The inputs ``_hvp`` hands the kernel pass the wrapper's checks (dtype,
  shape, layout) on real factors and CG directions, so a card run cannot
  fail on them, and the wrapper refuses CPU tensors and malformed inputs.
  ``e_ij`` and ``x`` reach the kernel strided (the batch builders and the
  slot permutation leave ``e_ij`` so, and a direction may be a view of a
  wider state), and the rehearsal reads both at their strides.

This file imports neither JAX nor ``cg_mrslam_tpu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cg_mrslam_tpu_torch.core.graph import permute_vertices
from cg_mrslam_tpu_torch.ops import pcg_hvp as PH
from cg_mrslam_tpu_torch.sim import graphs as GR
from cg_mrslam_tpu_torch.solver import fixed_sum as FS
from cg_mrslam_tpu_torch.solver import pcg as P

torch.set_num_threads(2)

# float32: a bar on each row's Σ|Jᵀ||Ω||J||x| (see the module docstring)
REL32, REL64 = 1e-5, 1e-12


def _segment_rows(segs: FS.Segments) -> None:
    """Row by row, the compressed rows against the table."""
    table = segs.table.numpy()
    entries, offsets = segs.entries.numpy(), segs.offsets.numpy()
    n, k = table.shape[0], entries.shape[0]
    assert offsets.shape == (n + 1,) and offsets[0] == 0
    assert np.all(np.diff(offsets) >= 0)
    for r in range(n):
        row = table[r][table[r] < k]
        np.testing.assert_array_equal(entries[offsets[r]:offsets[r + 1]], row)
        assert np.all(table[r][len(row):] == k)
    # every contribution once: the listed ones, then the inactive ones
    assert sorted(entries.tolist()) == list(range(k))
    assert offsets[n] == int((table < k).sum())


def test_segment_table_compressed_rows():
    rng = np.random.default_rng(0)
    targets = torch.as_tensor(rng.integers(0, 9, 40))
    active = torch.as_tensor(rng.uniform(size=40) > 0.3)
    segs = FS.segment_table(targets, active, 10)     # row 9: no target
    _segment_rows(segs)
    assert int(segs.offsets[10] - segs.offsets[9]) == 0
    assert int(segs.offsets[-1]) == int(active.sum())


def _masked_batch(b: int, n: int = 40, seed: int = 1):
    """A batch of ring graphs with closures; a few edges masked, vertex 7
    of degree 0 (both its chain edges masked) and vertices 3 and 20
    fixed."""
    g = GR.build_hospital_batch(b, n=n, closures=6, seed=seed, device="cpu")
    emask = g.emask.clone()
    emask[..., [6, 7, 30]] = False
    fixed = g.fixed.clone()
    fixed[..., [3, 20]] = True
    return dataclasses.replace(g, emask=emask, fixed=fixed)


def _one(g, k=0):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name)[k]
                                     for f in dataclasses.fields(g)})


@pytest.mark.parametrize("batch", [False, True])
def test_edge_table_compressed_rows(batch):
    g = _masked_batch(3)
    g = g if batch else _one(g)
    segs = FS.edge_table(g.e_ij, g.emask, g.poses.shape[-2])
    _segment_rows(segs)
    deg = segs.offsets.diff().reshape(g.poses.shape[:-1])
    assert bool((deg[..., 7] == 0).all())
    assert int(segs.offsets[-1]) == 2 * int(g.emask.sum())


def _rehearsal(e_ij, Ji, Jj, omega, entries, offsets, free, x):
    """The kernel pair, step for step over the flat buffers it is given,
    vectorized over threads (see the module docstring)."""
    b, c, n, e = PH.check_inputs(e_ij, Ji, Jj, omega, entries, offsets,
                                 free, x)
    # e_ij at its strides over its storage, as the kernel reads it
    sb = e_ij.stride(0) if e_ij.dim() == 3 else 0
    se, sk = e_ij.stride(-2), e_ij.stride(-1)
    eij = _storage(e_ij)
    JI, JJ, OM = (t.numpy().reshape(-1) for t in (Ji, Jj, omega))
    # x as [B, C, N, 3] at its strides over its storage
    xs = x.view(b, c, n, 3).stride()
    X = _storage(x)
    ENT, OFF = entries.numpy(), offsets.numpy()
    FREE = free.numpy().reshape(-1)
    dt = X.dtype
    # scratch as the wrapper leaves it: unwritten (NaN shows a stray read)
    contrib = np.full(2 * b * e * c * 3, np.nan, dt)

    # edge pass: thread t = (b·E + e)·C + c
    t = np.arange(b * e * c)
    cc, be = t % c, t // c
    bb = be // e
    xbc = bb * xs[0] + cc * xs[1]

    def load3(v):
        ok = (v >= 0) & (v < n)
        at = xbc + xs[2] * np.where(ok, v, 0)
        return [np.where(ok, X[at + r * xs[3]], dt.type(0))
                for r in range(3)]

    m = be * 9

    def mv(M, v):
        return [M[m + 3 * r] * v[0] + M[m + 3 * r + 1] * v[1]
                + M[m + 3 * r + 2] * v[2] for r in range(3)]

    def mtv(M, v):
        return [M[m + r] * v[0] + M[m + 3 + r] * v[1] + M[m + 6 + r] * v[2]
                for r in range(3)]

    ends = bb * sb + (be - bb * e) * se
    xi, xj = load3(eij[ends]), load3(eij[ends + sk])
    u = [p + q for p, q in zip(mv(JI, xi), mv(JJ, xj))]
    w = mv(OM, u)
    ci = (be * c + cc) * 3
    cj = ((b * e + be) * c + cc) * 3
    for r, (yi, yj) in enumerate(zip(mtv(JI, w), mtv(JJ, w))):
        contrib[ci + r] = yi
        contrib[cj + r] = yj

    # vertex pass: thread t = (b·C + c)·N + n, its entries in order
    t = np.arange(b * c * n)
    nn, bc = t % n, t // n
    cc = bc % c
    row = (bc // c) * n + nn
    lo, hi = OFF[row], OFF[row + 1]
    acc = np.zeros((3, t.size), dt)
    for step in range(int((hi - lo).max(initial=0))):
        p = lo + step
        live = p < hi
        at = (ENT[np.where(live, p, 0)].astype(np.int64) * c + cc) * 3
        for r in range(3):
            acc[r] += np.where(live, contrib[at + r], dt.type(0))
    y = acc.T * FREE[row].astype(dt)[:, None]
    return torch.as_tensor(y.reshape(x.shape))


def _storage(t):
    """``t``'s storage from its first element to its last, flat, as the
    kernels address it (element strides from ``t.data_ptr()``)."""
    span = 1 + sum((k - 1) * st for k, st in zip(t.shape, t.stride()))
    return torch.as_strided(t, (span,), (1,)).numpy()


def _inputs(g, f, x):
    return (g.e_ij, f.Ji, f.Jj, f.omega, f.segs.entries, f.segs.offsets,
            f.free, x)


def _scale(g, f, x):
    """Per row ``Σ|Jᵀ||Ω||J||x|``: the plain product of the absolute
    values."""
    fa = f._replace(Ji=f.Ji.abs(), Jj=f.Jj.abs(), omega=f.omega.abs())
    return P._hvp_plain(g, fa, x.abs())


CASES = {"one graph, 8 columns": (False, (8,)), "batch": (True, ()),
         "batch, columns": (True, (2, 3)),
         "batch, strided x": (True, "strided")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rehearsal_matches_plain(case, dtype):
    batch, cols = CASES[case]
    g = _masked_batch(3)
    g = g if batch else _one(g)
    g = dataclasses.replace(g, **{k: getattr(g, k).to(dtype)
                                  for k in ("poses", "e_z", "e_info")})
    f = P._factorize(g, None)
    assert not bool(f.free.all()) and bool(f.free.any())
    lead = g.poses.shape[:-2]
    if cols == "strided":
        # a CG direction held at strides of its own: every other entry of a
        # wider state
        cols = ()
        wide = torch.zeros(lead + g.poses.shape[-2:-1] + (6,), dtype=dtype)
        wide[..., ::2] = P._tridiag_precond(g, f)(f.b)
        x = wide[..., ::2]
        assert not x.is_contiguous()
    else:
        x = torch.as_tensor(np.random.default_rng(2).normal(
            size=lead + cols + g.poses.shape[-2:]), dtype=dtype)
    got = _rehearsal(*_inputs(g, f, x))
    want = P._hvp(g, f, x)
    assert got.shape == want.shape == x.shape and got.dtype == dtype
    bar = (REL64 if dtype == torch.float64 else REL32) * _scale(g, f, x)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= bar).all()), \
        float(((got - want).abs() / bar.clamp(min=1e-300)).max())
    # frozen and degree-0 vertices read exactly 0 on both sides
    frozen = ~f.free.reshape(lead + (1,) * len(cols) + g.poses.shape[-2:-1])
    assert bool((got.masked_select(frozen[..., None]) == 0).all())
    assert bool((want.masked_select(frozen[..., None]) == 0).all())


def test_kernel_inputs_pass_the_wrappers_checks(monkeypatch):
    """What ``_hvp`` hands the kernel on every call of a solve: batched and
    batch-1 PCG solves and marginal solves of the merged graph under its
    chain order (the CG directions as the preconditioner's solve lays
    them out, the 3Q marginal columns)."""
    g, order, _ = GR.build_merged_batch(2, device="cpu")
    plain = P._hvp
    seen = []

    def checked(gg, f, x):
        seen.append(PH.check_inputs(*_inputs(gg, f, x)))
        return plain(gg, f, x)

    monkeypatch.setattr(P, "_hvp", checked)
    n, e = g.poses.shape[-2], g.e_ij.shape[-2]
    q = torch.tensor([100, 700])
    for gg in (g, _one(g)):
        b = 2 if gg.poses.dim() == 3 else 1
        del seen[:]
        P.optimize_pcg(gg, 1, cg_iters=8, order=order)
        assert seen and set(seen) == {(b, 1, n, e)}
        del seen[:]
        P.marginal_covariance_pcg(gg, q, cg_iters=8, order=order)
        assert seen and set(seen) == {(b, 6, n, e)}


def test_wrapper_refuses_cpu_and_malformed_inputs():
    g = _masked_batch(2)
    f = P._factorize(g, None)
    x = torch.zeros_like(g.poses)
    before = PH.PCG_HVP.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        PH.PCG_HVP(*_inputs(g, f, x))
    bad = {"entries": f.segs.entries.long(),
           "offsets": f.segs.offsets[:-1],
           "x": torch.zeros(g.poses.shape[:-2] + (3, 2) + g.poses.shape[-2:]
                            ).transpose(1, 2),
           "free": f.free.int()}
    for name, value in bad.items():
        args = dict(zip(("e_ij", "Ji", "Jj", "omega", "entries", "offsets",
                         "free", "x"), _inputs(g, f, x)))
        args[name] = value
        with pytest.raises(ValueError, match=f"^{name}"):
            PH.check_inputs(**args)
    with pytest.raises(ValueError, match="float32 or float64"):
        PH.check_inputs(*_inputs(g, f, x.half()))
    # a CPU solve takes the plain version
    P.optimize_pcg(g, 1, cg_iters=4)
    assert PH.PCG_HVP.launches == before
