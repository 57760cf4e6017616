"""Datagram transport between robot processes.

Port of ``cg_mrslam_tpu/mr/transport.py``, the counterpart of the
reference's UDP backend (``graph_comm.cpp``): each robot process binds one
UDP socket whose address is a function of its id and exchanges
fire-and-forget datagrams of the ``mr/wire.py`` codec. The transport is the
port's own native library (``native/udp_comm.cpp``: a bound socket, a
receiver thread and a locked queue — the reference's ``receiveFromThrd`` /
``processQueueThrd``). ``native=False`` binds a non-blocking Python socket
instead; only the caller chooses it. Nothing switches paths on its own:
a library that cannot be built raises ``RuntimeError``, a port that cannot
be bound raises ``OSError`` naming it. Neither socket sets ``SO_REUSEADDR``,
so a port that another socket holds fails to bind instead of sharing its
datagrams.

Two addressing schemes:

* **lan** (the reference's, a ``base_addr`` ending in ``.``): robot ``i`` at
  ``base_addr + (i+1)``, all on ``base_port`` (``graph_comm.cpp:41-51``);
* **localhost** (one machine): all robots on ``base_addr``, robot ``i`` on
  ``base_port + i + 1``.
"""

from __future__ import annotations

import ctypes
import errno
import os
import socket
from typing import List, Optional, Tuple

MAX_DATAGRAM = 100_000   # msg_factory.h:115
DEFAULT_PORT = 42001     # graph_comm.cpp:41


def peer_addresses(n_robots: int, base_addr: str = "127.0.0.1",
                   base_port: int = DEFAULT_PORT
                   ) -> List[Tuple[str, int]]:
    """Address of each robot id under the two schemes."""
    if base_addr.endswith("."):
        return [(f"{base_addr}{i + 1}", base_port) for i in range(n_robots)]
    return [(base_addr, base_port + i + 1) for i in range(n_robots)]


class UdpTransport:
    """One robot's endpoint: bind my address, send and receive raw
    datagrams."""

    def __init__(self, robot_id: int, n_robots: int,
                 base_addr: str = "127.0.0.1",
                 base_port: int = DEFAULT_PORT, native: bool = True):
        self.robot_id = robot_id
        self.addrs = peer_addresses(n_robots, base_addr, base_port)
        for ip, _ in self.addrs:
            socket.inet_aton(ip)          # OSError on a malformed address
        self.my_addr = self.addrs[robot_id]
        port = self.my_addr[1]
        self._lib = self._h = self._sock = None
        if native:
            from cg_mrslam_tpu_torch import native as N

            lib = N.udp_lib()
            h = lib.udp_create(port)
            if h < 0:
                raise OSError(-h, f"cannot bind UDP port {port}: "
                                  f"{os.strerror(-h)}")
            self._lib, self._h = lib, h
            self._buf = ctypes.create_string_buffer(MAX_DATAGRAM)
        else:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.bind(("0.0.0.0", port))
            except OSError as exc:
                s.close()
                raise OSError(exc.errno, f"cannot bind UDP port {port}: "
                                         f"{exc.strerror}") from exc
            s.setblocking(False)
            self._sock = s
            self._buf = bytearray(MAX_DATAGRAM)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def send(self, peer: int, data: bytes) -> bool:
        """Fire-and-forget to robot ``peer`` (``graph_comm.cpp:103-122``).
        Returns False when the datagram was refused as undeliverable (no
        socket bound at the peer's port: UDP's own loss); raises on any
        other send error."""
        if len(data) > MAX_DATAGRAM:
            raise ValueError(f"datagram {len(data)} B > {MAX_DATAGRAM}")
        ip, port = self.addrs[peer]
        if self._lib is not None:
            n = self._lib.udp_send(self._h, ip.encode(), port, bytes(data),
                                   len(data))
            if n == -errno.ECONNREFUSED:
                return False
            if n < 0:
                raise OSError(-n, f"UDP send to {ip}:{port}: "
                                  f"{os.strerror(-n)}")
            return n == len(data)
        try:
            return self._sock.sendto(data, (ip, port)) == len(data)
        except ConnectionRefusedError:
            return False

    def recv(self) -> Optional[bytes]:
        """Pop one queued datagram (into the one receive buffer, then
        copied out); None when none is waiting."""
        if self._lib is not None:
            n = self._lib.udp_recv(self._h, self._buf, MAX_DATAGRAM, None,
                                   None)
            if n < 0:
                raise OSError(f"UDP receive on port {self.my_addr[1]} "
                              "failed")
            return ctypes.string_at(self._buf, n) if n else None
        try:
            n = self._sock.recv_into(self._buf)
        except (BlockingIOError, ConnectionRefusedError):
            return None
        return bytes(memoryview(self._buf)[:n])

    def drain(self, limit: int = 256) -> List[bytes]:
        """All queued datagrams (at most ``limit``), oldest first."""
        out = []
        for _ in range(limit):
            d = self.recv()
            if d is None:
                break
            out.append(d)
        return out

    def close(self) -> None:
        if self._lib is not None:
            self._lib.udp_close(self._h)
            self._lib = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
