"""The port's datagram transport (``cg_mrslam_tpu_torch/mr/transport.py``,
``native/udp_comm.cpp``) against ``cg_mrslam_tpu``'s: the cases of
``tests/test_udp_transport.py`` that need no robot node, plus what the
port adds — it raises where the reference falls back.

* ``peer_addresses`` equals the reference's under both schemes;
* the native library builds (with ``-pthread``, into ``build/native/``);
* a localhost round trip, drain order and the drain bound, on the native
  transport and on the explicit ``native=False`` Python socket;
* a port held by a socket without ``SO_REUSEADDR`` makes either path raise
  ``OSError`` naming the port (the reference quietly binds a Python socket
  or shares the port);
* a broken ``udp_comm.cpp`` makes ``build`` and the transport raise
  ``RuntimeError`` (the reference returns ``None`` and falls back);
* a JAX transport and a port transport exchange datagrams byte for byte in
  both directions, and wire messages of each package decode in the other.

Ports come from ``free_base_port`` (per xdist worker, probed).
"""

import socket
import time

import numpy as np
import pytest
import torch

from cg_mrslam_tpu.mr import mrslam as JMR
from cg_mrslam_tpu.mr import transport as jtransport
from cg_mrslam_tpu.mr import wire as jwire
from cg_mrslam_tpu_torch import native as N
from cg_mrslam_tpu_torch.mr import mrslam as TMR
from cg_mrslam_tpu_torch.mr import wire as twire
from cg_mrslam_tpu_torch.mr.transport import UdpTransport, peer_addresses
from test_wire import _state as _jstate
from torch_port_helpers import CPU, free_base_port, npy

torch.set_num_threads(1)


def _wait(t, deadline=5.0):
    end = time.time() + deadline
    while time.time() < end:
        got = t.recv()
        if got is not None:
            return got
        time.sleep(0.01)
    return None


@pytest.mark.parametrize("n,addr,port", [(3, "192.168.0.", 42001),
                                         (2, "127.0.0.1", 42001),
                                         (4, "10.0.0.7", 45000)])
def test_peer_addresses_match_reference(n, addr, port):
    assert peer_addresses(n, addr, port) == jtransport.peer_addresses(
        n, addr, port)


def test_native_library_builds():
    lib = N.build(N.UDP_SRC, ("-pthread",))
    assert lib.exists() and lib.parent == N.BUILD_DIR
    L = N.udp_lib()
    assert L.udp_pending(10_000) == -1          # a bad handle, not a crash


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_roundtrip_drain_order_and_bound(native):
    base = free_base_port(2, slot=1 if native else 2)
    with UdpTransport(0, 2, base_port=base, native=native) as t0, \
            UdpTransport(1, 2, base_port=base, native=native) as t1:
        assert t0.native is native and t1.native is native
        payload = b"\x01\x02" * 500
        assert t0.send(1, payload)
        assert _wait(t1) == payload
        for k in range(8):
            assert t0.send(1, bytes([k]))
        time.sleep(0.3)
        assert [m[0] for m in t1.drain()] == list(range(8))
        for k in range(150):
            t1.send(0, k.to_bytes(2, "little"))
        time.sleep(0.5)
        first, rest = t0.drain(limit=100), t0.drain(limit=100)
        assert len(first) == 100 and len(rest) == 50
        assert [int.from_bytes(m, "little") for m in first + rest] == \
            list(range(150))
        with pytest.raises(ValueError):
            t0.send(1, bytes(twire.MAX_DATAGRAM + 1))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_held_port_raises(native):
    base = free_base_port(2, slot=3 if native else 4)
    holder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    holder.bind(("0.0.0.0", base + 1))       # robot 0's port, no REUSEADDR
    try:
        with pytest.raises(OSError, match=f"port {base + 1}"):
            UdpTransport(0, 2, base_port=base, native=native)
        # the other robot's port is free and binds
        UdpTransport(1, 2, base_port=base, native=native).close()
    finally:
        holder.close()
    with pytest.raises(OSError):
        UdpTransport(0, 2, base_addr="not.an.address", base_port=base)


def test_broken_source_raises(tmp_path, monkeypatch):
    bad = tmp_path / "udp_comm.cpp"
    bad.write_text(N.UDP_SRC.read_text().replace("int udp_create(int port) {",
                                                 "int udp_create(int port) {{"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.build(bad, ("-pthread",))
    monkeypatch.setattr(N, "UDP_SRC", bad)
    monkeypatch.setattr(N, "_UDP", None)
    with pytest.raises(RuntimeError):
        UdpTransport(0, 2, base_port=free_base_port(2, slot=5))


def test_jax_and_port_transports_exchange():
    """Robot 0 on the reference's transport, robot 1 on the port's: raw
    bytes both ways, then a wire message of each package read by the
    other."""
    base = free_base_port(2, slot=6)
    tj = jtransport.UdpTransport(0, 2, base_port=base)
    tt = UdpTransport(1, 2, base_port=base)
    try:
        assert tj.native and tt.native
        raw = bytes(range(256)) * 7
        assert tj.send(1, raw) and _wait(tt) == raw
        assert tt.send(0, raw[::-1]) and _wait(tj) == raw[::-1]
        st, _ = _jstate(my_id=0)
        jc = JMR.build_combo(st)
        tj.send(1, jwire.encode(jc))
        sender, tc = twire.decode(_wait(tt), device="cpu")
        assert sender == 0 and isinstance(tc, TMR.Combo)
        np.testing.assert_array_equal(npy(tc.poses),
                                      np.asarray(jc.poses, np.float32))
        assert tc.ranges.device == CPU
        tt.send(0, twire.encode(tc))
        sender, back = jwire.decode(_wait(tj))
        assert sender == 0
        np.testing.assert_array_equal(np.asarray(back.ranges),
                                      np.asarray(jc.ranges, np.float32))
        np.testing.assert_array_equal(np.asarray(back.idxs),
                                      np.asarray(jc.idxs))
    finally:
        tj.close()
        tt.close()


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two processes that build ``udp_comm.cpp`` into the same empty
    directory at the same time each end with a library that loads and
    binds: each compiles into a private file that is renamed into place."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    base = free_base_port(2, slot=7)
    code = ("import sys; from pathlib import Path; "
            "from cg_mrslam_tpu_torch import native as N; "
            "N.BUILD_DIR = Path(sys.argv[1]); "
            "from cg_mrslam_tpu_torch.mr.transport import UdpTransport; "
            "UdpTransport(int(sys.argv[2]), 2, base_port=int(sys.argv[3]))"
            ".close(); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               str(r), str(base)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0 and out.strip() == "ok", err[-2000:]
    libs = sorted(tmp_path.glob("libudp_comm-*.so"))
    assert len(libs) == 1 and not list(tmp_path.glob("tmp*")), \
        list(tmp_path.iterdir())
