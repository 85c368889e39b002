"""The benchmark's inputs: the body meshes and the gait files, made from the
seed.  Frozen copies of the generators the port's smoke test uses, so that
a later change to the port cannot move what the benchmark feeds it:

- `create_sphere` and its refinement through a spherical manifold: copies
  of `bemstokes_tpu_torch/mesh/factories.py:82` `create_sphere` and
  `mesh/refine.py:123` `_refine_once` (uniform refinement only);
- the flagellum tube and its spiral: copies of
  `bemstokes_tpu_torch/flagella.py` `create_initial_flagellum_mesh`,
  `reference_spiral_euler` and `euler_at_theta`, in numpy;
- `write_bacterium_gait` and `write_msh`: `chip_smoke.py:4500` and
  `chip_smoke.py:2078`, with the jitter drawn from the run's seed.

Everything here is host numpy and writes gmsh v2 files; nothing imports the
port.
"""

from __future__ import annotations

import math
import os

import numpy as np


def _project_sphere(pts, parents, center):
    """Radial projection through the mean parent radius (the port's
    `SphericalManifold.project`)."""
    rel = pts - center
    r_new = np.linalg.norm(rel, axis=-1, keepdims=True)
    r_parent = np.mean(np.linalg.norm(parents - center, axis=-1), axis=-1)[:, None]
    return center + rel / r_new * r_parent


def _refine_once(vertices, cells, center):
    verts = [v for v in vertices]
    edge_mid: dict[tuple[int, int], int] = {}
    new_cells = []

    def midpoint(a, b, parents):
        key = (min(a, b), max(a, b))
        if key in edge_mid:
            return edge_mid[key]
        p = 0.5 * (np.asarray(verts[a]) + np.asarray(verts[b]))
        p = _project_sphere(p[None, :], parents[None, :, :], center)[0]
        verts.append(p)
        edge_mid[key] = len(verts) - 1
        return edge_mid[key]

    for c in range(len(cells)):
        v00, v10, v01, v11 = (int(x) for x in cells[c])
        quad = np.asarray([verts[i] for i in (v00, v10, v01, v11)])
        e_b = midpoint(v00, v10, quad[[0, 1]])
        e_t = midpoint(v01, v11, quad[[2, 3]])
        e_l = midpoint(v00, v01, quad[[0, 2]])
        e_r = midpoint(v10, v11, quad[[1, 3]])
        pc = _project_sphere((0.25 * quad.sum(axis=0))[None, :], quad[None, :, :], center)[0]
        verts.append(pc)
        vc = len(verts) - 1
        new_cells += [
            [v00, e_b, e_l, vc],
            [e_b, v10, vc, e_r],
            [e_l, vc, v01, e_t],
            [vc, e_r, e_t, v11],
        ]
    return np.asarray(verts), np.asarray(new_cells, dtype=np.int64)


def create_sphere(center=(0.0, 0.0, 0.0), radius=1.0, refinements=3):
    """(vertices [n, 3], cells [Nc, 4] lexicographic): the cube's six faces
    projected onto the sphere and refined `refinements` times."""
    center = np.asarray(center, dtype=np.float64)
    a = radius / np.sqrt(3.0)
    corners = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)], dtype=np.float64)
    verts = (2.0 * corners - 1.0) * a + center
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
                    if side == 1:
                        bits[u], bits[v] = cu, cv
                    else:
                        bits[u], bits[v] = cv, cu
                    cell.append(bits[0] * 4 + bits[1] * 2 + bits[2])
            cells.append(cell)
    cells = np.asarray(cells, dtype=np.int64)
    for _ in range(refinements):
        verts, cells = _refine_once(verts, cells, center)
    return verts, cells


#: the flagellum's parameters (`flagella.FlagellumConfig` defaults)
FLAGELLUM = dict(
    Lx=7.17952051265,
    alpha=0.761770785745,
    k=1.31273083546,
    ke=1.31273083546,
    delta_head_flagellum=0.125,
    a=0.1,
)


def flagellum_tube(n_length, n_around, f=FLAGELLUM):
    """The straight tube of radius a along x, open at both ends."""
    x = np.linspace(f["delta_head_flagellum"], f["delta_head_flagellum"] + f["Lx"], n_length + 1)
    phi = np.linspace(0, 2 * np.pi, n_around, endpoint=False)
    verts = np.zeros(((n_length + 1) * n_around, 3))
    for i, xi in enumerate(x):
        for j, pj in enumerate(phi):
            verts[i * n_around + j] = (xi, f["a"] * np.sin(pj), f["a"] * np.cos(pj))
    cells = []
    for i in range(n_length):
        for j in range(n_around):
            j2 = (j + 1) % n_around
            cells.append([i * n_around + j, (i + 1) * n_around + j, i * n_around + j2, (i + 1) * n_around + j2])
    return verts, np.asarray(cells, dtype=np.int64)


def reference_spiral(verts, f=FLAGELLUM):
    """The tube deformed to the growing-amplitude spiral."""
    X, Y, Z = verts[:, 0], verts[:, 1], verts[:, 2]
    k, ke, alpha, delta = f["k"], f["ke"], f["alpha"], f["delta_head_flagellum"]
    phi = np.arctan2(Y, Z)
    x = X - delta
    aa = np.sqrt(Y * Y + Z * Z)
    E = 1.0 - np.exp(-((ke * x) ** 2))
    E2 = 1.0 - np.exp(-(ke**3 * x * ke * x))
    Ep = 2.0 * ke**2 * x * np.exp(-((ke * x) ** 2))
    theta = k * x - math.pi
    D = np.sqrt(1.0 + alpha**2 * ((E * k) ** 2 + Ep**2))
    G = np.sqrt((E * k) ** 2 + Ep**2)
    G = np.where(G == 0, 1.0, G)
    H = alpha * aa * D / G * np.sin(phi)
    M = aa / G * (
        (E * k * np.sin(theta) - Ep * np.cos(theta)) / D * np.sin(phi)
        + (Ep * np.sin(theta) + E * k * np.cos(theta)) * np.cos(phi)
    )
    N = aa / G * (
        (E * k * np.sin(theta) - Ep * np.cos(theta)) * np.cos(phi)
        - (Ep * np.sin(theta) + E * k * np.cos(theta)) / D * np.sin(phi)
    )
    new = np.stack([x + E2 * H + delta, alpha * E * np.cos(theta) + M, alpha * E * np.sin(theta) + N], axis=-1)
    return np.where((x > 0.0)[:, None], new, verts)


def turn_about_x(verts, theta):
    ct, st = math.cos(theta), math.sin(theta)
    return verts @ np.array([[1.0, 0.0, 0.0], [0.0, ct, -st], [0.0, st, ct]]).T


def weld(va, ca, vb, cb, tol=1e-12):
    """Concatenate two meshes, welding coincident vertices (the port's
    `SurfaceMesh.merged_with`)."""
    verts = np.concatenate([va, vb])
    cells = np.concatenate([ca, cb + len(va)])
    rounded = np.round(verts / tol).astype(np.int64)
    _, first, inverse = np.unique(rounded, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return verts[first[order]], rank[inverse[cells]]


def write_msh(path, vertices, cells):
    """A gmsh v2 file of a quad surface mesh (cells lexicographic; the file
    holds them counterclockwise)."""
    n, nc = len(vertices), len(cells)
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{n}\n")
        np.savetxt(f, np.column_stack([np.arange(1, n + 1), vertices]), fmt="%d %.17g %.17g %.17g")
        f.write(f"$EndNodes\n$Elements\n{nc}\n")
        rows = np.column_stack([np.arange(1, nc + 1), np.full((nc, 4), [3, 2, 0, 0]), cells[:, [0, 1, 3, 2]] + 1])
        np.savetxt(f, rows, fmt="%d")
        f.write("$EndElements\n")


def jitter(shape, size, seed):
    """The seeded vertex jitter: `size` times a standard normal draw."""
    return size * np.random.default_rng(seed).standard_normal(shape)


def write_bacterium_gait(folder, base, geometry, seed):
    """`geometry["frames_per_turn"]` gmsh files `<base><k>.msh`: the head
    sphere merged with the tube on the spiral, turned about x by 2 pi k /
    frames_per_turn, every vertex moved by the same seeded jitter."""
    head_v, head_c = create_sphere(geometry["head_center"], geometry["head_radius"], geometry["head_refinements"])
    tube_v, tube_c = flagellum_tube(*geometry["tube"])
    spiral = reference_spiral(tube_v)
    turn = geometry["frames_per_turn"]
    verts0, cells = weld(head_v, head_c, spiral, tube_c)
    offsets = jitter(verts0.shape, geometry["jitter"], seed)
    for k in range(turn):
        verts, _ = weld(head_v, head_c, turn_about_x(spiral, 2.0 * np.pi * k / turn), tube_c)
        write_msh(os.path.join(folder, f"{base}{k}.msh"), verts + offsets, cells)
    return len(verts0)


def write_sphere_frame(folder, base, geometry, seed):
    """One gmsh file `<base>0.msh` of the refined sphere, jittered."""
    verts, cells = create_sphere(geometry["center"], geometry["radius"], geometry["refinements"])
    write_msh(os.path.join(folder, f"{base}0.msh"), verts + jitter(verts.shape, geometry["jitter"], seed), cells)
    return len(verts)


WRITERS = {"bacterium": write_bacterium_gait, "sphere": write_sphere_frame}


def write_inputs(folder, base, geometry, seed):
    """Write the frame files of a configuration's `geometry` into folder;
    returns the number of vertices of a frame."""
    return WRITERS[geometry["kind"]](folder, base, geometry, seed)
