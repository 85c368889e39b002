"""Wall / box mesh factories (reference `create_coarse_wall`
`source/bem_stokes.cc:1202-1322`, `create_wall` `:1324-1358`, `create_box`
`:1360-1411`, `refine_walls` `:1478-1519`).

A wall is a flat rectangular quad patch: `position` is its center, `span`
has a zero entry on the wall-normal axis and half-extents on the two
in-plane axes.  Material ids encode the BC type (surface_mesh constants).
The cell orientation is chosen so the parametric normal points from the wall
toward the origin (the fluid side), matching the reference's vertex-ordering
cases; `flip_normal` reverses it.
"""

from __future__ import annotations

import numpy as np

from .surface_mesh import SurfaceMesh, WALL_TYPE_TO_MATERIAL
from .refine import refine_uniform


def create_wall(
    position,
    span,
    wall_type: str = "no_slip",
    flip_normal: bool = False,
    refinements: int = 1,
) -> SurfaceMesh:
    position = np.asarray(position, dtype=np.float64)
    span = np.asarray(span, dtype=np.float64)
    (normal_axis,) = np.nonzero(span == 0.0)[0][:1] if np.any(span == 0.0) else (None,)
    if normal_axis is None:
        raise ValueError("a wall needs a zero span entry (the normal axis)")
    t0, t1 = [i for i in range(3) if i != normal_axis]
    s0 = np.zeros(3)
    s0[t0] = span[t0]
    s1 = np.zeros(3)
    s1[t1] = span[t1]

    # lexicographic corners of the quad in the (t0, t1) plane
    verts = np.stack(
        [
            position - s0 - s1,  # (0,0)
            position + s0 - s1,  # (1,0)
            position - s0 + s1,  # (0,1)
            position + s0 + s1,  # (1,1)
        ]
    )
    cell = np.array([[0, 1, 2, 3]], dtype=np.int32)
    # parametric normal of this ordering is e_t0 x e_t1; flip the cell when
    # that is not the wanted direction (toward the origin / fluid side)
    e = np.zeros(3)
    e[normal_axis] = 1.0
    param_normal_sign = np.dot(np.cross(verts[1] - verts[0], verts[2] - verts[0]), e)
    want_sign = -np.sign(position[normal_axis]) if position[normal_axis] != 0 else 1.0
    if flip_normal:
        want_sign = -want_sign
    if np.sign(param_normal_sign) != want_sign:
        cell = cell[:, [1, 0, 3, 2]]  # mirror the parametrization

    mat = np.array([WALL_TYPE_TO_MATERIAL[wall_type]], dtype=np.int32)
    wall = SurfaceMesh(verts, cell, mat)
    if refinements:
        wall = refine_uniform(wall, times=refinements)
    return wall


def create_box(walls_cfg, refinements: int = 1) -> SurfaceMesh:
    """Six walls merged into a closed box (reference `create_box`); each
    entry of walls_cfg has .position/.span/.wall_type/.flip_normal."""
    assert len(walls_cfg) == 6, "a box needs exactly 6 wall configs"
    box = None
    for w in walls_cfg:
        wall = create_wall(
            w.position, w.span, w.wall_type, w.flip_normal, refinements=0
        )
        box = wall if box is None else box.merged_with(wall)
    if refinements:
        box = refine_uniform(box, times=refinements)
    return box


def create_sphere(
    center=(0.0, 0.0, 0.0), radius: float = 1.0, refinements: int = 3
) -> SurfaceMesh:
    """Unit-style sphere built in code: the 6-quad surface of a cube
    projected onto the sphere, refined through a SphericalManifold — the
    analog of deal.II `GridGenerator::hyper_sphere` used by the reference's
    `build_sphere_in_code` branch (`source/bem_stokes.cc:670-711`)."""
    from .refine import SphericalManifold

    center = np.asarray(center, dtype=np.float64)
    a = radius / np.sqrt(3.0)
    # cube corners indexed by bits (x, y, z)
    corners = np.array(
        [[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)], dtype=np.float64
    )
    verts = (2.0 * corners - 1.0) * a + center
    # per face-normal axis: the in-plane (u, v) axes whose cross product is
    # the outward normal; lexicographic corner order (0,0),(1,0),(0,1),(1,1)
    uv_plus = {0: (1, 2), 1: (2, 0), 2: (0, 1)}
    cells = []
    for axis in range(3):
        u, v = uv_plus[axis]
        for side in (1, 0):
            cell = []
            for cv in (0, 1):
                for cu in (0, 1):
                    bits = [0, 0, 0]
                    bits[axis] = side
                    # outward normal flips on the side=0 face: swap u <-> v
                    if side == 1:
                        bits[u], bits[v] = cu, cv
                    else:
                        bits[u], bits[v] = cv, cu
                    cell.append(bits[0] * 4 + bits[1] * 2 + bits[2])
            # lexicographic order is (0,0),(1,0),(0,1),(1,1) = indices 0,1,2,3
            cells.append([cell[0], cell[1], cell[2], cell[3]])
    mesh = SurfaceMesh(
        verts, np.asarray(cells, dtype=np.int32), np.zeros(6, dtype=np.int32)
    )
    if refinements:
        mesh = refine_uniform(
            mesh, SphericalManifold(center, radius=radius), times=refinements
        )
    return mesh


def create_cube(
    center=(0.0, 0.0, 0.0), half_width: float = 1.0, refinements: int = 2
) -> SurfaceMesh:
    """Closed cube surface built in code (flat refinement, NO manifold
    projection) — the body the reference's `Cube` grid_type / cube test
    family runs on (`V_test_with_Green_cube.cc` etc.; deal.II hyper_cube
    boundary).  Sharp edges and corners exercise the solid-angle correction
    away from the smooth-surface case."""
    sphere0 = create_sphere(
        center=center, radius=half_width * np.sqrt(3.0), refinements=0
    )
    if refinements:
        sphere0 = refine_uniform(sphere0, manifold=None, times=refinements)
    return sphere0


def create_body_in_code(cfg) -> SurfaceMesh:
    """The reference's `build_sphere_in_code` geometry for ImposedForce /
    ImposedVelocity / Convergence runs: one unit sphere at the origin, or two
    unit spheres `spheres_distance` apart along x when `two_spheres` is set
    (`source/bem_stokes.cc:670-711`)."""
    refinements = cfg.internal_sphere_refinements
    sphere = create_sphere(refinements=refinements)
    if not cfg.two_spheres:
        return sphere
    second = create_sphere(
        center=(cfg.spheres_distance, 0.0, 0.0), refinements=refinements
    )
    return sphere.merged_with(second)


def add_walls_to_mesh(mesh: SurfaceMesh, cfg) -> SurfaceMesh:
    """Attach configured walls / box to a swimmer mesh (reference
    `compute_euler_vector` wall insertion, `source/bem_stokes.cc:2312-2340`).
    `cfg` is a ProblemConfig."""
    walls = list(cfg.walls)
    if cfg.create_box:
        i0 = cfg.first_index_box
        box_walls = walls[i0 : i0 + 6]
        others = walls[:i0] + walls[i0 + 6 :]
        for w in others:
            if w.enabled:
                mesh = mesh.merged_with(
                    create_wall(w.position, w.span, w.wall_type, w.flip_normal)
                )
        mesh = mesh.merged_with(create_box(box_walls))
    else:
        for w in walls:
            if w.enabled:
                mesh = mesh.merged_with(
                    create_wall(w.position, w.span, w.wall_type, w.flip_normal)
                )
    cyl = getattr(cfg, "cylinder", None)
    if cyl is not None and (cyl.create or cyl.import_mesh):
        if cyl.import_mesh:
            from .io import read_mesh

            cw = read_mesh(cyl.mesh_filename, dim=3)
            cw = SurfaceMesh(
                cw.vertices,
                cw.cells,
                np.full(cw.n_cells, WALL_TYPE_TO_MATERIAL[cyl.wall_type], np.int32),
                np.full(cw.n_cells, bool(cyl.flip_normal)),
            )
        else:
            cw = create_cylindrical_wall(
                cyl.radius,
                cyl.height,
                cyl.direction,
                cyl.point_on_axis,
                cyl.wall_type,
                cyl.flip_normal,
                apply_manifold=cyl.apply_manifold,
            )
        mesh = mesh.merged_with(cw)
    wr = getattr(cfg, "wall_refinement", None)
    if wr is not None and wr.enabled:
        # local wall refinement near the body (reference `read_domain`
        # applies it right after the wall factories, `:808`); the hanging
        # nodes it creates are constrained in the solve
        mesh = refine_walls(
            mesh,
            max_distance=wr.distance_from_center,
            threshold=wr.threshold,
            center=wr.center[: mesh.dim],
            gradual=wr.gradual,
        )
    return mesh


def create_cylindrical_wall(
    radius: float = 1.0,
    height: float = 2.0,
    direction=(0.0, 0.0, 1.0),
    point_on_axis=(0.0, 0.0, 0.0),
    wall_type: str = "no_slip",
    flip_normal: bool = False,
    n_around: int = 8,
    n_length: int = 4,
    refinements: int = 0,
    apply_manifold: bool = True,
) -> SurfaceMesh:
    """Open cylindrical wall tube (reference `create_cylindrical_wall`,
    `source/bem_stokes.cc:887-1156`): axis `direction` through
    `point_on_axis`, extending ±height/2.  Parametric normals point inward
    (toward the axis, the fluid side for a container); `flip_normal`
    reverses.  Refinement snaps to the cylinder via CylindricalManifold
    unless `apply_manifold` is false (the reference's
    `cylinder_manifold_bool` gate on `add_cylinder_to_tria`, `:794-806`)."""
    from .refine import CylindricalManifold

    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    p0 = np.asarray(point_on_axis, dtype=np.float64)
    # orthonormal frame (e1, e2, d)
    ref = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    e1 = np.cross(d, ref)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)

    z = np.linspace(-height / 2.0, height / 2.0, n_length + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, n_around, endpoint=False)
    verts = np.empty(((n_length + 1) * n_around, 3))
    for i, zi in enumerate(z):
        for j, pj in enumerate(phi):
            verts[i * n_around + j] = (
                p0 + zi * d + radius * (np.cos(pj) * e1 + np.sin(pj) * e2)
            )
    cells = []
    for i in range(n_length):
        for j in range(n_around):
            j2 = (j + 1) % n_around
            v00 = i * n_around + j
            v10 = i * n_around + j2
            v01 = (i + 1) * n_around + j
            v11 = (i + 1) * n_around + j2
            # ordering (z, phi) lexicographic: t_u x t_v = d x phi_hat,
            # which points toward the axis (the fluid side of a container)
            cells.append([v00, v01, v10, v11])
    cells = np.asarray(cells, dtype=np.int32)
    mat = np.full(len(cells), WALL_TYPE_TO_MATERIAL[wall_type], dtype=np.int32)
    mesh = SurfaceMesh(
        verts,
        cells,
        mat,
        np.full(len(cells), bool(flip_normal)),
    )
    if refinements:
        manifold = (
            CylindricalManifold(direction=d, point_on_axis=p0)
            if apply_manifold
            else None
        )
        mesh = refine_uniform(mesh, manifold, times=refinements)
    return mesh


def refine_walls(
    mesh: SurfaceMesh,
    max_distance: float,
    threshold: float,
    center=(0.0, 0.0, 0.0),
    gradual: bool = False,
    max_rounds: int = 10,
) -> SurfaceMesh:
    """Refine no-slip / free-surface wall cells near `center` until their
    diameter falls under `threshold` (reference `refine_walls`,
    `source/bem_stokes.cc:1478-1519`).  The refinement is LOCAL: only
    triggered cells split, and the resulting hanging nodes are handled by
    `mesh.constraints.hanging_node_constraints` in the solve."""
    center = np.asarray(center, dtype=np.float64)
    for _ in range(max_rounds):
        verts = mesh.vertices[mesh.cells]  # [Nc, 4, 3]
        diameters = np.max(
            np.linalg.norm(verts[:, :, None, :] - verts[:, None, :, :], axis=-1),
            axis=(1, 2),
        )
        dist = np.min(np.linalg.norm(verts - center, axis=-1), axis=1)
        thr = threshold * (
            np.clip(dist / max_distance, 0.1, 1.0) if gradual else 1.0
        )
        is_wall = (mesh.material_id == 2) | (mesh.material_id == 3)
        trigger = is_wall & (dist < max_distance) & (diameters > thr)
        if not np.any(trigger):
            break
        mesh = refine_uniform(mesh, cell_filter=trigger)
    return mesh
