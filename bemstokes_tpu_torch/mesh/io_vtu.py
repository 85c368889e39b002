"""Minimal VTU (VTK XML unstructured grid) writer for quad surface meshes
with point-data fields — the replacement for deal.II DataOut::write_vtu
(reference `output_save_stokes_results`, `source/bem_stokes.cc:5164-5262`)."""

from __future__ import annotations


import numpy as np


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

    def da(name, arr, ncomp=None):
        arr = np.asarray(arr)
        if arr.ndim == 1:
            ncomp = ncomp or 1
            flat = arr
        else:
            ncomp = arr.shape[1]
            flat = arr.reshape(-1)
        vals = " ".join(f"{v:.12g}" for v in flat)
        return (
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">{vals}</DataArray>'
        )

    pd = ""
    if point_data:
        pd = "<PointData>" + "".join(
            da(k, v) for k, v in point_data.items()
        ) + "</PointData>"
    cd = ""
    if cell_data:
        cd = "<CellData>" + "".join(
            da(k, v) for k, v in cell_data.items()
        ) + "</CellData>"

    conn_s = " ".join(str(int(i)) for i in conn.reshape(-1))
    offs = " ".join(str((i + 1) * nv) for i in range(ncel))
    types = " ".join(str(vtk_type) for _ in range(ncel))
    pts_s = " ".join(f"{v:.12g}" for v in points.reshape(-1))

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
<UnstructuredGrid>
<Piece NumberOfPoints="{npts}" NumberOfCells="{ncel}">
{pd}{cd}
<Points><DataArray type="Float64" NumberOfComponents="3" format="ascii">{pts_s}</DataArray></Points>
<Cells>
<DataArray type="Int32" Name="connectivity" format="ascii">{conn_s}</DataArray>
<DataArray type="Int32" Name="offsets" format="ascii">{offs}</DataArray>
<DataArray type="UInt8" Name="types" format="ascii">{types}</DataArray>
</Cells>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    with open(path, "w") as f:
        f.write(xml)
