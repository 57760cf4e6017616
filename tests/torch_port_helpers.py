"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages as the
same float32 arrays (``tests/conftest.py`` turns on JAX's x64 mode, so
every JAX input is pinned to float32 explicitly). The port runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from cg_mrslam_tpu_torch import convert

CPU = torch.device("cpu")


def npy(x) -> np.ndarray:
    """A JAX array or a torch tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jf(a):
    """numpy → JAX, floats pinned to float32 and ints to int32."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return jnp.asarray(a, jnp.float32)
    if a.dtype.kind in "iu":
        return jnp.asarray(a, jnp.int32)
    return jnp.asarray(a)


def tf(a):
    """numpy → torch on the CPU, floats float32 and ints int32."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32)
    return torch.as_tensor(a).clone()


def port(jax_obj, cls):
    """The port's dataclass ``cls`` holding the same values as the
    reference dataclass ``jax_obj``."""
    return convert.from_numpy(cls, convert.to_numpy(jax_obj), CPU)


def assert_same_fields(a, b, rtol=0.0, atol=0.0):
    """Every leaf of two dataclass trees (either package) agrees."""
    fa, fb = convert.to_numpy(a), convert.to_numpy(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_allclose(x.astype(np.float64),
                                       y.astype(np.float64), rtol=rtol,
                                       atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(x.astype(np.int64),
                                          y.astype(np.int64), err_msg=k)



# --- the command line of both packages (tests/test_torch_cli*.py) ---


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS translation error after SE(2) alignment of the first pose."""
    def compose(a, b):
        c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
        return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                         a[..., 1] + s * b[..., 0] + c * b[..., 1],
                         a[..., 2] + b[..., 2]], -1)

    e0 = est[0].astype(np.float64)
    c, s = np.cos(e0[2]), np.sin(e0[2])
    inv = np.array([-(c * e0[0] + s * e0[1]), -(-s * e0[0] + c * e0[1]),
                    -e0[2]])
    aligned = compose(compose(gt[0], inv), est.astype(np.float64))
    return float(np.sqrt(np.mean(np.sum(
        (aligned[:, :2] - gt[:, :2]) ** 2, axis=1))))


def run_cli(main, argv, cwd, monkeypatch, slam_cls=None, **kw):
    """Run a package's ``main(argv, **kw)`` in ``cwd``. Returns its stdout
    and, with ``slam_cls`` (the package's ``SingleRobotSlam``), the tick of
    every keyframe (``observe`` counts the ticks from 1)."""
    import contextlib
    import io

    ticks = []
    if slam_cls is not None:
        observe = slam_cls.observe
        calls = [0]

        def spy(self, rel, ranges):
            calls[0] += 1
            kf = observe(self, rel, ranges)
            if kf:
                ticks.append(calls[0])
            return kf

        monkeypatch.setattr(slam_cls, "observe", spy)
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    monkeypatch.undo()
    assert rc in (0, None), out.getvalue()[-2000:]
    return out.getvalue(), ticks


def keyframe_lines(stdout: str) -> list:
    """``(sm, closures)`` of every ``keyframe`` line a run printed."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("keyframe "):
            f = dict(t.split("=", 1) for t in line.split()[2:])
            out.append((int(f["sm"]), int(f["closures"].lstrip("+"))))
    return out


def compare_graph_files(ref_path, port_path, first_closure=None):
    """Two ``.g2o`` files of one run: equal ids (and so the same vertex
    count) and, up to vertex slot ``first_closure`` (the first keyframe
    that accepted a closure), poses within 1e-3 m / rad. Returns both
    packages' poses in slot order."""
    from cg_mrslam_tpu.io import g2o as JIO

    a = JIO.load(str(ref_path), native=False)
    b = JIO.load(str(port_path), native=False)
    np.testing.assert_array_equal(a.ids, b.ids)
    pa, pb = npy(a.graph.poses), npy(b.graph.poses)
    k = len(pa) if first_closure is None else first_closure
    d = pa[:k] - pb[:k]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d).max(initial=0.0) <= 1e-3, np.abs(d).max()
    return pa, pb


def compare_maps(ref_pgm, port_pgm, share=0.99):
    """Two ``.pgm`` maps of one run: the same size, and at least ``share``
    of the cells equal."""
    a, b = (open(p, "rb").read() for p in (ref_pgm, port_pgm))
    ha, hb = a.split(b"255\n", 1), b.split(b"255\n", 1)
    assert ha[0] == hb[0]          # "P5\nW H\n"
    ia = np.frombuffer(ha[1], np.uint8)
    ib = np.frombuffer(hb[1], np.uint8)
    assert (ia == ib).mean() >= share, (ia == ib).mean()
