"""Native (C++) components, loaded with ``ctypes``: the bulk ``.g2o`` parser
(``g2o_parser.cpp``, the port's own copy).

The library is built at its first use, not at import, with ``g++ -O3
-shared -fPIC -std=c++17`` into ``build/native/`` at the repository root
(found from this package, not from the working directory), named by a hash
of the source, so a changed source builds anew. A failed build, a failed
load or a malformed file raises: nothing here returns a value for a caller
to fall back on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "g2o_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = None


def build(src: Path = SRC) -> Path:
    """Compile ``src`` into ``build/native/`` (skipped when a library built
    from the same bytes is there) and return the library's path. Raises
    ``RuntimeError`` when the compiler fails."""
    text = Path(src).read_bytes()
    tag = hashlib.sha1(text).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{Path(src).stem}-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o",
           tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) on {src}:\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def lib() -> ctypes.CDLL:
    """The parser library, built and loaded once per process."""
    global _LIB
    if _LIB is None:
        L = ctypes.CDLL(str(build()))
        LL = ctypes.c_longlong
        LLP = ctypes.POINTER(LL)
        DP = ctypes.POINTER(ctypes.c_double)
        U8P = ctypes.POINTER(ctypes.c_uint8)
        L.g2o_count.argtypes = [ctypes.c_char_p, LLP, LLP, LLP, LLP]
        L.g2o_count.restype = LL
        L.g2o_parse.argtypes = [ctypes.c_char_p, LL, LLP, DP, U8P, LLP, DP,
                                DP, LLP, DP, DP]
        L.g2o_parse.restype = LL
        _LIB = L
    return _LIB


def _check(rc: int, path: str) -> None:
    if rc == -1:
        raise OSError(f"cannot read {path}")
    if rc != 0:
        raise ValueError(f"{path}:{rc}: malformed .g2o line")


def parse_g2o(path: str) -> dict:
    """Parse a ``.g2o`` file into numpy arrays: ``v_ids [V]``, ``v_pose
    [V,3]``, ``v_fixed [V]``, ``e_ids [E,2]``, ``e_z [E,3]``, ``e_info
    [E,6]``, ``l_vertex [L]`` (the vertex each scan follows), ``l_meta
    [L,10]`` (first beam angle, fov, step, max range, laser pose, odometry
    pose) and ``l_ranges [L, B]`` (padded with the max range)."""
    L = lib()
    LL = ctypes.c_longlong
    nv, ne, nl, mb = LL(), LL(), LL(), LL()
    enc = os.fsencode(path)
    _check(L.g2o_count(enc, ctypes.byref(nv), ctypes.byref(ne),
                       ctypes.byref(nl), ctypes.byref(mb)), path)
    nv, ne, nl, mb = nv.value, ne.value, nl.value, max(mb.value, 1)
    out = {
        "v_ids": np.zeros(max(nv, 1), np.int64),
        "v_pose": np.zeros((max(nv, 1), 3), np.float64),
        "v_fixed": np.zeros(max(nv, 1), np.uint8),
        "e_ids": np.zeros((max(ne, 1), 2), np.int64),
        "e_z": np.zeros((max(ne, 1), 3), np.float64),
        "e_info": np.zeros((max(ne, 1), 6), np.float64),
        "l_vertex": np.zeros(max(nl, 1), np.int64),
        "l_meta": np.zeros((max(nl, 1), 10), np.float64),
        "l_ranges": np.zeros((max(nl, 1), mb), np.float64),
    }
    ptr = {np.int64: ctypes.POINTER(LL),
           np.float64: ctypes.POINTER(ctypes.c_double),
           np.uint8: ctypes.POINTER(ctypes.c_uint8)}
    args = [a.ctypes.data_as(ptr[a.dtype.type]) for a in out.values()]
    _check(L.g2o_parse(enc, mb, *args), path)
    count = {"v": nv, "e": ne, "l": nl}
    return {k: a[:count[k[0]]] for k, a in out.items()}
