"""Minimal VTU (VTK XML unstructured grid) writer for quad surface meshes
with point-data fields — the replacement for deal.II DataOut::write_vtu
(reference `output_save_stokes_results`, `source/bem_stokes.cc:5164-5262`).

Every DataArray is ASCII: a Float64 value as `%.12g`, an Int32 or UInt8
value in decimal, single spaces between them.  `csrc/vtu_text.cpp` formats
an array in one native pass, built with g++ at the first write
(`ops/cuda_build.py`); where it cannot be built or loaded, Python formats
each value, to the same bytes.  The counters "VTU values native" and
"VTU values python" count the values each route wrote."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import cuda_build
from ..utils import timers

SOURCE = cuda_build.CSRC / "vtu_text.cpp"
BYTES_PER_VALUE = 25  # the longest "%.12g", "-1.23456789012e-308", and a space: 20


def _declare(lib):
    for name, ctype in (("vtu_text_f64", ctypes.c_double), ("vtu_text_i64", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ctype), ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int64


@functools.cache
def native_lib():
    """The loaded formatter, built at first use, or None where it cannot be
    built or loaded (no g++)."""
    try:
        return cuda_build.library(SOURCE, _declare)
    except (OSError, RuntimeError):
        return None


def text_native(values, integer=False):
    """The ASCII of `values` formatted by the native library, a memoryview
    of bytes, or None without it."""
    lib = native_lib()
    if lib is None:
        return None
    ctype, fn = (ctypes.c_int64, "vtu_text_i64") if integer else (ctypes.c_double, "vtu_text_f64")
    flat = np.ascontiguousarray(values, dtype=np.int64 if integer else np.float64).reshape(-1)
    buf = np.empty(BYTES_PER_VALUE * flat.size, np.uint8)
    n = getattr(lib, fn)(flat.ctypes.data_as(ctypes.POINTER(ctype)), flat.size, buf.ctypes.data)
    return memoryview(buf)[:n]


def text_python(values, integer=False) -> bytes:
    """The same bytes, one Python format a value."""
    flat = np.asarray(values).reshape(-1)
    if integer:
        return " ".join(str(int(i)) for i in flat).encode()
    return " ".join(f"{v:.12g}" for v in flat).encode()


def _text(values, integer=False):
    """One DataArray's ASCII, counted as native or python values."""
    text = text_native(values, integer)
    if text is None:
        text = text_python(values, integer)
        timers.count("VTU values python", np.size(values))
    else:
        timers.count("VTU values native", np.size(values))
    return text


def write_vtu(
    path: str,
    points: np.ndarray,  # [n, 3]
    cells: np.ndarray,  # [Nc, 4] lexicographic quad corners
    point_data: dict | None = None,  # name -> [n] or [n, k]
    cell_data: dict | None = None,  # name -> [Nc]
):
    points = np.asarray(points, dtype=np.float64)
    if points.shape[1] == 2:
        points = np.hstack([points, np.zeros((len(points), 1))])
    cells = np.asarray(cells)
    # lexicographic (v00, v10, v01, v11) -> VTK_QUAD counterclockwise
    if cells.shape[1] == 4:
        conn = cells[:, [0, 1, 3, 2]]
        vtk_type = 9
    else:  # lines (2D problems)
        conn = cells
        vtk_type = 3
    npts, ncel = len(points), len(cells)
    nv = conn.shape[1]

    def da(name, arr):
        arr = np.asarray(arr)
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        return [
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">'.encode(),
            _text(arr),
            b"</DataArray>",
        ]

    def section(tag, data):
        if not data:
            return []
        body = [b for k, v in data.items() for b in da(k, v)]
        return [f"<{tag}>".encode(), *body, f"</{tag}>".encode()]

    parts = [
        f'<?xml version="1.0"?>\n'
        f'<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n'
        f"<UnstructuredGrid>\n"
        f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncel}">\n'.encode(),
        *section("PointData", point_data),
        *section("CellData", cell_data),
        b'\n<Points><DataArray type="Float64" NumberOfComponents="3" format="ascii">',
        _text(points),
        b'</DataArray></Points>\n<Cells>\n<DataArray type="Int32" Name="connectivity" format="ascii">',
        _text(conn, integer=True),
        b'</DataArray>\n<DataArray type="Int32" Name="offsets" format="ascii">',
        _text(np.arange(1, ncel + 1) * nv, integer=True),
        b'</DataArray>\n<DataArray type="UInt8" Name="types" format="ascii">',
        _text(np.full(ncel, vtk_type), integer=True),
        b"</DataArray>\n</Cells>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n",
    ]
    with open(path, "wb") as f:
        f.writelines(parts)
