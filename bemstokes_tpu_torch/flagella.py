"""Analytic helical flagellum geometry (reference FlagellarGeometryHandler,
`source/flagellar_geometry_handler.cc`): build an initial cylindrical tube
mesh, deform it to the Phan-Thien/Ramia/Shum growing spiral (or a perfect
constant spiral), and rotate it about the x-axis to gait phase theta.

Port of `bemstokes_tpu/flagella.py`.  All deformations are vectorized torch
maps over the node-position tensor; the initial tube is a host-side numpy
mesh factory (copied).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .mesh.surface_mesh import SurfaceMesh


@dataclasses.dataclass
class FlagellumConfig:
    """Reference parameter names/defaults
    (`source/flagellar_geometry_handler.cc:26-35`)."""

    Nlambda: float = 1.5  # turns of the spiral
    Lx: float = 7.17952051265  # length along x
    alpha: float = 0.761770785745  # amplitude
    k: float = 1.31273083546  # wave number
    ke: float = 1.31273083546  # growth (reduction) parameter
    delta_head_flagellum: float = 0.125
    a: float = 0.1  # cross-section radius


def create_initial_flagellum_mesh(
    cfg: FlagellumConfig, n_length: int = 24, n_around: int = 8
) -> SurfaceMesh:
    """Cylindrical tube of radius a from x = delta to delta + Lx, axis e_x —
    the analog of the reference's extracted-boundary hyper-rectangle +
    cylindrical manifold (`create_initial_flagellum_triangulation`,
    `:43-102`), built directly as a structured tube (no end caps, matching
    the open tube the reference extracts after removing anisotropy)."""
    x = np.linspace(cfg.delta_head_flagellum, cfg.delta_head_flagellum + cfg.Lx, n_length + 1)
    phi = np.linspace(0, 2 * np.pi, n_around, endpoint=False)
    # vertex grid [n_length+1, n_around]
    verts = np.zeros(((n_length + 1) * n_around, 3))
    for i, xi in enumerate(x):
        for j, pj in enumerate(phi):
            verts[i * n_around + j] = (xi, cfg.a * np.sin(pj), cfg.a * np.cos(pj))
    cells = []
    for i in range(n_length):
        for j in range(n_around):
            j2 = (j + 1) % n_around
            v00 = i * n_around + j
            v10 = i * n_around + j2
            v01 = (i + 1) * n_around + j
            v11 = (i + 1) * n_around + j2
            # lexicographic (u, v) = (x, phi): t_x x t_phi = +radial, so the
            # parametric normal points OUT of the tube (into the fluid)
            cells.append([v00, v01, v10, v11])
    return SurfaceMesh(
        verts, np.asarray(cells, dtype=np.int32), np.zeros(len(cells), dtype=np.int32)
    )


def reference_spiral_euler(
    euler: torch.Tensor, cfg: FlagellumConfig, flagellum_mask: torch.Tensor
) -> torch.Tensor:
    """Deform tube node positions [n, 3] to the growing-amplitude spiral
    (reference `compute_reference_euler`, `:125-172`).  Nodes outside
    `flagellum_mask` (or with x <= delta) are left in place."""
    c = cfg
    X, Y, Z = euler[:, 0], euler[:, 1], euler[:, 2]
    phi = torch.atan2(Y, Z)
    x = X - c.delta_head_flagellum
    aa = torch.sqrt(Y * Y + Z * Z)
    E = 1.0 - torch.exp(-((c.ke * x) ** 2))
    E2 = 1.0 - torch.exp(-(c.ke**3 * x * c.ke * x))
    Eprime = 2.0 * c.ke**2 * x * torch.exp(-((c.ke * x) ** 2))
    theta = c.k * x - math.pi
    D = torch.sqrt(1.0 + c.alpha**2 * ((E * c.k) ** 2 + Eprime**2))
    G = torch.sqrt((E * c.k) ** 2 + Eprime**2)
    G = torch.where(G == 0, torch.ones_like(G), G)
    H = c.alpha * aa * D / G * torch.sin(phi)
    M = (
        aa
        / G
        * (
            (E * c.k * torch.sin(theta) - Eprime * torch.cos(theta)) / D * torch.sin(phi)
            + (Eprime * torch.sin(theta) + E * c.k * torch.cos(theta)) * torch.cos(phi)
        )
    )
    N = (
        aa
        / G
        * (
            (E * c.k * torch.sin(theta) - Eprime * torch.cos(theta)) * torch.cos(phi)
            - (Eprime * torch.sin(theta) + E * c.k * torch.cos(theta)) / D * torch.sin(phi)
        )
    )
    new = torch.stack(
        [
            x + E2 * H + c.delta_head_flagellum,
            c.alpha * E * torch.cos(theta) + M,
            c.alpha * E * torch.sin(theta) + N,
        ],
        dim=-1,
    )
    apply = (flagellum_mask > 0) & (x > 0.0)
    return torch.where(apply[:, None], new, euler)


def reference_constant_spiral_euler(
    euler: torch.Tensor, cfg: FlagellumConfig, flagellum_mask: torch.Tensor
) -> torch.Tensor:
    """Perfect constant spiral with tapered ends (reference
    `compute_reference_euler_constant_spiral`, `:181-238`)."""
    c = cfg
    X, Y, Z = euler[:, 0], euler[:, 1], euler[:, 2]
    phi = torch.atan2(Y, Z)
    x = X - c.delta_head_flagellum
    aa = torch.sqrt(Y * Y + Z * Z)
    one = torch.ones_like(x)
    E3 = torch.where(x < 0.2, (x + 0.1) / 0.3, one)
    E4 = torch.where(c.Lx - x < 0.2, (c.Lx + 0.1 - x) / 0.3, one)
    a_eff = E3 * E4 * aa
    theta = c.k * x - math.pi
    D = math.sqrt(1.0 + c.alpha**2 * c.k**2)
    H = c.alpha * a_eff * D / c.k * torch.sin(phi)
    M = a_eff / c.k * (
        c.k * torch.sin(theta) / D * torch.sin(phi) + c.k * torch.cos(theta) * torch.cos(phi)
    )
    N = a_eff / c.k * (
        c.k * torch.sin(theta) / D * torch.cos(phi)
        - c.k * torch.cos(theta) * torch.sin(phi) / D
    )
    new = torch.stack(
        [
            x + H + c.delta_head_flagellum,
            c.alpha * torch.cos(theta) + M,
            c.alpha * torch.sin(theta) + N,
        ],
        dim=-1,
    )
    return torch.where((flagellum_mask > 0)[:, None], new, euler)


def euler_at_theta(
    reference_euler: torch.Tensor, theta: float, flagellum_mask: torch.Tensor
) -> torch.Tensor:
    """Rotate the flagellum nodes about the x-axis to gait phase theta
    (reference `compute_euler_at_theta`, `:263-294`)."""
    ct, st = math.cos(theta), math.sin(theta)
    Rm = torch.tensor(
        [[1.0, 0.0, 0.0], [0.0, ct, -st], [0.0, st, ct]],
        dtype=reference_euler.dtype,
        device=reference_euler.device,
    )
    rotated = reference_euler @ Rm.T
    return torch.where((flagellum_mask > 0)[:, None], rotated, reference_euler)
