"""Image-system Green's functions for a flat wall, as torch elementwise
functions (port of `bemstokes_tpu/kernels/images.py`).

Two wall models, behaviorally matching the reference:

- free surface (perfect slip): mirror Stokeslet/stresslet with a sign flip on
  the wall-normal row (reference `source/free_surface_kernel.cc:19-209`);
- no-slip plane wall (Blake-type system): mirror Stokeslet plus h0-weighted
  source-doublet / Stokes-doublet corrections (reference
  `source/no_slip_wall_kernel.cc:23-199`, including its exact sign structure
  and the literal `delta_ij * pI_k * delta_jk * pI_i` product term).

Conventions: p = x_q - x_i is the vector from the collocation point to the
quadrature point; p_image = x_q - x_i^image with the image point mirrored
across the wall plane along axis `wall_axis`.  The collocation height above
the wall is h0 = (p_image - p)[wall_axis] / 2.

`wall_axis` is a Python int, so all masks are constants.  3D only, like the
reference (2D asserts there).  These are the oracles the CUDA image sweeps
(`ops/node_kernel.py`, K2 and K3) are tested against.
"""

from __future__ import annotations

import math

import torch

from ..utils import timers
from .stokeslet import _eye, _ipow, _norm, stokeslet_G_Wn, stresslet_W


def image_point(x: torch.Tensor, wall_axis: int, wall_position: float) -> torch.Tensor:
    """Mirror collocation points across the wall plane
    (reference `source/bem_stokes.cc:2917-2920`)."""
    shift = torch.zeros_like(x)
    shift[..., wall_axis] = 2.0 * (x[..., wall_axis] - wall_position)
    return x - shift


def _unnormalized_G3(p, eps):
    R = _norm(p, eps)
    pp = p[..., :, None] * p[..., None, :]
    return pp / _ipow(R, 3)[..., None, None] + _eye(p.shape[-1], p) / R[..., None, None]


def _unnormalized_W3(p, eps, dim_power_extra=0):
    dim = p.shape[-1]
    R = _norm(p, eps)
    ppp = p[..., :, None, None] * p[..., None, :, None] * p[..., None, None, :]
    return ppp / _ipow(R, dim + 2 + dim_power_extra)[..., None, None, None]


def _unit(dim, axis, like):
    e = torch.zeros((dim,), dtype=like.dtype, device=like.device)
    with timers.host_sync():  # a scalar copied in from the host
        e[axis] = 1.0
    return e


def _row_sign(dim, wall_axis, like):
    """s_i = -1 on the wall-normal row, +1 elsewhere."""
    s = torch.ones((dim,), dtype=like.dtype, device=like.device)
    with timers.host_sync():
        s[wall_axis] = -1.0
    return s


def free_surface_G(
    p: torch.Tensor,
    p_image: torch.Tensor,
    wall_axis: int,
    eps: float = 0.0,
    sign_on: str = "row",
) -> torch.Tensor:
    """Free-surface image Stokeslet.

    sign_on == "row": the image contribution enters with a minus sign on the
    wall-normal *row* (reference `value_tens_image`); "col": minus on the
    wall-normal *column* (the `_old`/`_pimponi` variants used in tests).
    """
    dim = p.shape[-1]
    assert dim == 3, "image kernels are 3D-only, as in the reference"
    G0 = _unnormalized_G3(p, eps)
    GI = _unnormalized_G3(p_image, eps)
    s = _row_sign(dim, wall_axis, p)
    if sign_on == "row":
        G = G0 + s[:, None] * GI
    elif sign_on == "col":
        G = G0 + s[None, :] * GI
    else:
        raise ValueError(sign_on)
    return G / (4.0 * math.pi * (dim - 1))


def free_surface_W(
    p: torch.Tensor,
    p_image: torch.Tensor,
    wall_axis: int,
    eps: float = 0.0,
    sign_on: str = "row",
) -> torch.Tensor:
    """Free-surface image stresslet: sign flip on the wall-normal row
    (first index) of the image term (reference `value_tens_image2`)."""
    dim = p.shape[-1]
    assert dim == 3
    scale = -dim / (2.0 * math.pi * (dim - 1))
    W0 = scale * _unnormalized_W3(p, eps)
    WI = scale * _unnormalized_W3(p_image, eps)
    s = _row_sign(dim, wall_axis, p)
    if sign_on == "row":
        return W0 + s[:, None, None] * WI
    elif sign_on == "col":
        return W0 + s[None, :, None] * WI
    raise ValueError(sign_on)


def no_slip_wall_G(
    p: torch.Tensor, p_image: torch.Tensor, wall_axis: int, eps: float = 0.0
) -> torch.Tensor:
    """Blake-type no-slip wall Stokeslet (reference
    `no_slip_wall_kernel.cc:23-116`).

    G = G0(p) - G0(pI) + t_i * ( -2 h0^2 D + 2 h0 (pI_w D + SD) ),
    with D_ij = -3 pI_i pI_j / RI^5 + delta_ij / RI^3,
    SD_ij = (delta_iw pI_j - delta_jw pI_i) / RI^3,
    and t_i = +1 on the wall-normal row, -1 elsewhere.
    """
    dim = p.shape[-1]
    assert dim == 3
    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])[..., None, None]
    RI = _norm(p_image, eps)[..., None, None]
    eye = _eye(dim, p)
    pIpI = p_image[..., :, None] * p_image[..., None, :]
    base = _unnormalized_G3(p, eps) - _unnormalized_G3(p_image, eps)
    D = -3.0 * pIpI / _ipow(RI, 5) + eye / _ipow(RI, 3)
    e_w = _unit(dim, wall_axis, p)
    SD = (
        e_w[:, None] * p_image[..., None, :] - e_w[None, :] * p_image[..., :, None]
    ) / _ipow(RI, 3)
    pI_w = p_image[..., wall_axis][..., None, None]
    corr = -2.0 * h0 * h0 * D + 2.0 * h0 * (pI_w * D + SD)
    t = -_row_sign(dim, wall_axis, p)  # +1 on wall row, -1 elsewhere
    G = base + t[:, None] * corr
    return G / (4.0 * math.pi * (dim - 1))


def no_slip_wall_W(
    p: torch.Tensor, p_image: torch.Tensor, wall_axis: int, eps: float = 0.0
) -> torch.Tensor:
    """Blake-type no-slip wall stresslet (reference
    `no_slip_wall_kernel.cc:127-199`).

    W = [ W0u(p) - W0u(pI) + t'_i (2 h0^2 T - 2 h0 (pI_w T + U)) ]
          * dim / (2 pi (dim-1)),
    W0u = -p_i p_j p_k / R^(dim+2),
    T_ijk = -(d_ik pI_j + d_ij pI_k d_jk pI_i)/RI^(dim+2) + 5 pI_i pI_j pI_k / RI^(dim+4)
    (the d_ij pI_k d_jk pI_i *product* reproduces the reference literally),
    U_ijk = (d_jk pI_i pI_w - d_iw pI_j pI_k)/RI^(dim+2),
    t'_i = -1 on the wall-normal row, +1 elsewhere.
    """
    dim = p.shape[-1]
    assert dim == 3
    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])[..., None, None, None]
    RI = _norm(p_image, eps)[..., None, None, None]
    eye = _eye(dim, p)
    d_ik = eye[:, None, :]
    d_ij = eye[:, :, None]
    d_jk = eye[None, :, :]
    pIi = p_image[..., :, None, None]
    pIj = p_image[..., None, :, None]
    pIk = p_image[..., None, None, :]
    base = -_unnormalized_W3(p, eps) + _unnormalized_W3(p_image, eps)
    T = (
        -(d_ik * pIj + d_ij * pIk * d_jk * pIi) / _ipow(RI, dim + 2)
        + 5.0 * pIi * pIj * pIk / _ipow(RI, dim + 4)
    )
    pI_w = p_image[..., wall_axis][..., None, None, None]
    e_w = _unit(dim, wall_axis, p)
    U = (d_jk * pIi * pI_w - e_w[:, None, None] * pIj * pIk) / _ipow(RI, dim + 2)
    t = _row_sign(dim, wall_axis, p)  # -1 on wall row, +1 elsewhere
    W = base + t[:, None, None] * (2.0 * h0 * h0 * T - 2.0 * h0 * (pI_w * T + U))
    return W * dim / (2.0 * math.pi * (dim - 1))


def no_slip_wall_singular_GW(
    p: torch.Tensor,
    p_image: torch.Tensor,
    normal: torch.Tensor,
    wall_axis: int,
    eps: float = 0.0,
) -> torch.Tensor:
    """Combined singular kernel with wall terms: (W(p) - W(pI)) . n plus the
    h0-weighted Blake correction (reference `value_tens_image3`,
    `no_slip_wall_kernel.cc:210-265`). Returns [..., dim, dim]."""
    dim = p.shape[-1]
    assert dim == 3
    W1 = stresslet_W(p, eps)
    W2 = stresslet_W(p_image, eps)
    sk = torch.einsum("...ijk,...k->...ij", W1 - W2, normal)

    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])
    R = _norm(p, eps)
    RI = _norm(p_image, eps)
    RmNm = torch.sum(normal * p_image, dim=-1)
    x3 = p[..., wall_axis] + h0
    pI_w = p_image[..., wall_axis]
    e_w = _unit(dim, wall_axis, p)

    pIi = p_image[..., :, None]
    pIj = p_image[..., None, :]
    ni = normal[..., :, None]
    nj = normal[..., None, :]
    d_ij = _eye(dim, p)
    d_iw = e_w[:, None]
    d_jw = e_w[None, :]
    B = lambda a: a[..., None, None]  # broadcast scalar fields to [.., i, j]

    extra = (
        -d_jw * pIi * B(RmNm)
        + B(pI_w) * ni * (2.0 * d_jw * B(pI_w) - pIj)
        + B(x3)
        * (
            d_ij * B(RmNm)
            + pIi * nj
            - 2.0 * d_jw * (d_iw * B(RmNm) + pIi * B(normal[..., wall_axis]))
            + (5.0 * pIi * B(RmNm) / B(R * R) - ni)
            * (2.0 * d_jw * B(pI_w) - pIj)
        )
    ) * (0.3 * B(h0) / math.pi / B(_ipow(RI, dim + 2)) / 2.0)
    return sk + extra


def free_surface_G_Wn(p, p_image, n, wall_axis: int, eps: float = 0.0):
    """Fused (G, W . n) for the free-surface image kernel (row-sign
    convention of the assembly path)."""
    dim = p.shape[-1]
    assert dim == 3
    G0, Wn0 = stokeslet_G_Wn(p, n, eps)
    GI, WnI = stokeslet_G_Wn(p_image, n, eps)
    s = _row_sign(dim, wall_axis, p)
    return G0 + s[:, None] * GI, Wn0 + s[:, None] * WnI


def no_slip_wall_Wn(p, p_image, n, wall_axis: int, eps: float = 0.0):
    """Fused Blake stresslet contraction (W . n)_ij, analytically contracting
    every term of `no_slip_wall_W` with n_k (same literal term structure)."""
    dim = p.shape[-1]
    assert dim == 3
    h0 = 0.5 * (p_image[..., wall_axis] - p[..., wall_axis])[..., None, None]
    R = _norm(p, eps)[..., None, None]
    RI = _norm(p_image, eps)[..., None, None]
    eye = _eye(dim, p)
    pi_ = p[..., :, None]
    pj_ = p[..., None, :]
    pIi = p_image[..., :, None]
    pIj = p_image[..., None, :]
    ni = n[..., :, None]
    nj = n[..., None, :]
    pn = torch.sum(p * n, dim=-1)[..., None, None]
    pIn = torch.sum(p_image * n, dim=-1)[..., None, None]
    pI_w = p_image[..., wall_axis][..., None, None]
    e_w = _unit(dim, wall_axis, p)
    # base . n
    base = -pi_ * pj_ * pn / _ipow(R, 5) + pIi * pIj * pIn / _ipow(RI, 5)
    # T . n (the delta_ij pI_k delta_jk pI_i product term contracts to
    # delta_ij pI_i^2 n_i, preserving the reference's literal structure)
    pI2diag = eye * (p_image**2 * n)[..., :, None]  # delta_ij pI_i^2 n_i
    Tn = -(ni * pIj + pI2diag) / _ipow(RI, 5) + 5.0 * pIi * pIj * pIn / _ipow(RI, 7)
    # U . n
    Un = (nj * pIi * pI_w - e_w[:, None] * pIj * pIn) / _ipow(RI, 5)
    t = _row_sign(dim, wall_axis, p)
    Wn = base + t[:, None] * (2.0 * h0 * h0 * Tn - 2.0 * h0 * (pI_w * Tn + Un))
    return Wn * dim / (2.0 * math.pi * (dim - 1))
