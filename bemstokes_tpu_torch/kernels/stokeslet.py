"""Free-space Stokes Green's functions as torch elementwise functions,
vectorized over arbitrary batch shapes (port of
`bemstokes_tpu/kernels/stokeslet.py`).

Physics (exterior Stokes problem, viscosity mu = 1):

- single layer (Stokeslet / Oseen tensor), 3D:
      G_ij(p) = (p_i p_j / R^3 + delta_ij / R) / (8 pi)
  2D (log form):
      G_ij(p) = (p_i p_j / R^2 - delta_ij log R) / (4 pi)
- double layer (stresslet contracted later with the panel normal):
      W_ijk(p) = -dim p_i p_j p_k / R^(dim+2) / (2 pi (dim-1))

Behavioral parity with reference `source/kernel.cc:61-228` including the
epsilon regularization R -> R + eps (default 0).  All functions take
p[..., dim] and broadcast; dtype and device follow the input.  These are the
oracles the CUDA node sweep (`ops/node_kernel.py`) is tested against.
"""

from __future__ import annotations

import math

import torch


def _ipow(x, k: int):
    """x**k for a positive integer k by binary exponentiation — the same
    product order as jax's `integer_pow`, so both packages round alike."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def _dot(p, n):
    """Sum of p * n over the last axis, left to right — the rounding of the
    CUDA node sweep (`csrc/node_sweep.cu`), whose plain version evaluates
    `stokeslet_G_Wn`: R . n cancels heavily on a column's own panels."""
    acc = p[..., 0] * n[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc + p[..., k] * n[..., k]
    return acc


def _norm(p, eps):
    return torch.sqrt(torch.sum(p * p, dim=-1)) + eps


def _eye(dim, like):
    return torch.eye(dim, dtype=like.dtype, device=like.device)


def stokeslet_G(p: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Single-layer kernel. p[..., dim] -> G[..., dim, dim]."""
    dim = p.shape[-1]
    R = _norm(p, eps)[..., None, None]
    pp = p[..., :, None] * p[..., None, :]
    eye = _eye(dim, p)
    if dim == 2:
        G = pp / (R * R) - eye * torch.log(R)
    else:
        G = pp / (R * R * R) + eye / R
    return G / (4.0 * math.pi * (dim - 1))


def stresslet_W(p: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Double-layer kernel. p[..., dim] -> W[..., dim, dim, dim]."""
    dim = p.shape[-1]
    R = _norm(p, eps)
    ppp = p[..., :, None, None] * p[..., None, :, None] * p[..., None, None, :]
    scale = -dim / (2.0 * math.pi * (dim - 1))
    return scale * ppp / _ipow(R, dim + 2)[..., None, None, None]


def contract_normal(W: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """singular_kernel_ij = W_ijk n_k (reference `compute_singular_kernel`,
    `source/bem_stokes.cc:5075-5087`). W[..., d, d, d], n[..., d] -> [..., d, d]."""
    return torch.einsum("...ijk,...k->...ij", W, n)


def hypersingular_L(p: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Hypersingular 4-tensor (reference `value_tens3`,
    `source/kernel.cc:189-228`; flagged experimental there). p[..., dim] ->
    L[..., dim, dim, dim, dim]."""
    dim = p.shape[-1]
    R = _norm(p, eps)
    eye = _eye(dim, p)
    R3 = _ipow(R, 3)[..., None, None, None, None]
    R5 = _ipow(R, 5)[..., None, None, None, None]
    R7 = _ipow(R, 7)[..., None, None, None, None]
    d_im = eye[:, None, None, :]
    d_jk = eye[None, :, :, None]
    d_ij = eye[:, :, None, None]
    d_jm = eye[None, :, None, :]
    d_mk = eye[None, None, :, :]  # delta_{k m} (symmetric)
    d_ik = eye[:, None, :, None]
    pi = p[..., :, None, None, None]
    pj = p[..., None, :, None, None]
    pk = p[..., None, None, :, None]
    pm = p[..., None, None, None, :]
    L = (
        -4.0 * d_im * d_jk / R3
        - 6.0 * pk * (d_jm * pi + d_ij * pm) / R5
        - 6.0 * pj * (d_mk * pi + d_ik * pm) / R5
        + 60.0 * pi * pj * pk * pm / R7
    )
    return L / (-4.0 * math.pi * (dim - 1))


def stokeslet_G_Wn(p: torch.Tensor, n: torch.Tensor, eps: float = 0.0):
    """Fused (G, W . n) without materializing the rank-3 stresslet:
    (W . n)_ij = -dim p_i p_j (p . n) / R^(dim+2) / (2 pi (dim-1)).
    p[..., d], n[..., d] (broadcastable) -> ([..., d, d], [..., d, d]).

    eps == 0 (the default) takes the division-free rsqrt path — the
    assembly's plain node pass evaluates it once per (collocation,
    quadrature) pair."""
    dim = p.shape[-1]
    if eps == 0.0:
        r2 = _dot(p, p)
        invR = torch.rsqrt(r2)
        R = r2 * invR
    else:
        R = _norm(p, eps)
        invR = 1.0 / R
    pp = p[..., :, None] * p[..., None, :]
    eye = _eye(dim, p)
    if dim == 2:
        G = pp * (invR * invR)[..., None, None] - eye * torch.log(R)[..., None, None]
    else:
        invR3 = invR * invR * invR
        G = pp * invR3[..., None, None] + eye * invR[..., None, None]
    G = G / (4.0 * math.pi * (dim - 1))
    pn = _dot(p, n)
    scale = -dim / (2.0 * math.pi * (dim - 1))
    Wn = scale * pp * (pn * _ipow(invR, dim + 2))[..., None, None]
    return G, Wn
