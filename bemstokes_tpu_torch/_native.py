"""ctypes bindings for the native mesh core (native/meshcore.cpp).

A copy of `bemstokes_tpu/_native.py` (that package cannot be imported
without importing jax), whose `_build` also takes a file lock.  The shared
library is built on demand with the repo Makefile (a one-time `g++ -O3` of
a single TU); if the toolchain or the sources are unavailable every entry
point returns None and the callers take their numpy versions, which give the
same arrays: `mesh.io.read_mesh` its readers,
`ops/assemble.py:build_assembly_tables` its incidence loop.  This
is host-side mesh bookkeeping: nothing here decides where the solver runs.
Disable explicitly with BEMSTOKES_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import fcntl
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
    """Build the library once, however many processes ask at the same time:
    under an exclusive `flock` of the `native/` directory, into a file of
    this process's own that is then renamed over the library, so no process
    that takes the lock meets a half-written file.  A library that is there
    but does not load (written in place by a builder that took no lock) is
    built again."""
    src = os.path.join(_NATIVE_DIR, "meshcore.cpp")
    if not os.path.exists(src):
        return False
    fd = os.open(_NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(src):
            try:
                ctypes.CDLL(_SO)
                return True
            except OSError:
                pass
        tmp = f"{os.path.basename(_SO)}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(os.path.join(_NATIVE_DIR, tmp), _SO)
            return True
        except Exception:
            return False
        finally:
            if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
                os.remove(os.path.join(_NATIVE_DIR, tmp))
    finally:
        os.close(fd)  # releases the lock


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
        lib.mc_free.argtypes = [ctypes.c_void_p]
        lib.mc_incidence.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mc_incidence.restype = ctypes.c_int
        lib.mc_weld.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mc_weld.restype = ctypes.c_int64
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


def incidence_native(cells_nodes: np.ndarray, n_nodes: int):
    """Native node->(cell,local) incidence table. Returns (slots [n, vmax]
    int32, mask [n, vmax] float64) or None."""
    lib = get_lib()
    if lib is None:
        return None
    cn = np.ascontiguousarray(cells_nodes, dtype=np.int32)
    n_cells, nl = cn.shape
    slots_p = ctypes.POINTER(ctypes.c_int32)()
    mask_p = ctypes.POINTER(ctypes.c_double)()
    vmax = ctypes.c_int32()
    rc = lib.mc_incidence(
        cn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_cells,
        nl,
        n_nodes,
        ctypes.byref(slots_p),
        ctypes.byref(mask_p),
        ctypes.byref(vmax),
    )
    if rc != 0:
        return None
    try:
        v = vmax.value
        slots = np.ctypeslib.as_array(slots_p, shape=(n_nodes, v)).copy()
        mask = np.ctypeslib.as_array(mask_p, shape=(n_nodes, v)).copy()
    finally:
        lib.mc_free(slots_p)
        lib.mc_free(mask_p)
    return slots, mask


def weld_native(verts: np.ndarray, tol: float):
    """Native coincident-vertex weld. Returns (remap [n] int32, n_unique) or
    None."""
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, dtype=np.float64)
    n, dim = v.shape
    remap = np.empty(n, dtype=np.int32)
    n_unique = lib.mc_weld(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        dim,
        tol,
        remap.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n_unique <= 0:
        return None
    return remap, int(n_unique)
