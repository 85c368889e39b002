"""ctypes binding for the native mesh-file parser (native/meshcore.cpp).

A copy of the reader half of `bemstokes_tpu/_native.py` (that package cannot
be imported without importing jax).  The shared library is built on demand
with the repo Makefile (a one-time `g++ -O3` of a single TU); if the
toolchain or the sources are unavailable `read_mesh_native` returns None and
`mesh.io.read_mesh` takes its numpy readers, which parse the same files to
the same arrays.  This is a host-side file parser: nothing here decides
where the solver runs.  Disable explicitly with BEMSTOKES_NATIVE=0.

The library's incidence and weld entry points are not bound: the port
builds its incidence table in numpy (`ops/assemble.py`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO = os.path.join(_NATIVE_DIR, "libmeshcore.so")


class _MeshBuf(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_double)),
        ("n_verts", ctypes.c_int64),
        ("cells", ctypes.POINTER(ctypes.c_int32)),
        ("n_cells", ctypes.c_int64),
        ("nl", ctypes.c_int32),
        ("mat", ctypes.POINTER(ctypes.c_int32)),
    ]


def _build():
    src = os.path.join(_NATIVE_DIR, "meshcore.cpp")
    if not os.path.exists(src):
        return False
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(src):
        return True
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("BEMSTOKES_NATIVE", "1") == "0":
            return None
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.mc_read_msh.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(_MeshBuf),
        ]
        lib.mc_read_msh.restype = ctypes.c_int
        lib.mc_read_inp.argtypes = lib.mc_read_msh.argtypes
        lib.mc_read_inp.restype = ctypes.c_int
        lib.mc_free_mesh.argtypes = [ctypes.POINTER(_MeshBuf)]
        _lib = lib
        return _lib


def read_mesh_native(path: str, dim: int, fmt: str):
    """Parse a .msh/.inp file natively. Returns (verts, cells, mats) numpy
    arrays or None when the native library is unavailable/fails."""
    lib = get_lib()
    if lib is None:
        return None
    fn = lib.mc_read_msh if fmt == "msh" else lib.mc_read_inp if fmt == "inp" else None
    if fn is None:
        return None
    buf = _MeshBuf()
    rc = fn(path.encode(), dim, ctypes.byref(buf))
    if rc != 0:
        return None
    try:
        verts = np.ctypeslib.as_array(buf.verts, shape=(buf.n_verts, 3)).copy()
        cells = np.ctypeslib.as_array(
            buf.cells, shape=(buf.n_cells, buf.nl)
        ).copy()
        mats = np.ctypeslib.as_array(buf.mat, shape=(buf.n_cells,)).copy()
    finally:
        lib.mc_free_mesh(ctypes.byref(buf))
    return verts[:, :dim], cells, mats
