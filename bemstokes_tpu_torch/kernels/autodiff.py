"""Kernel derivatives by automatic differentiation (port of
`bemstokes_tpu/kernels/autodiff.py`).

The reference carries a Sacado-AD duplicate of every kernel
(`SacadoKernel<rank,dim>::sacado_value/2`, `gradient_tens`,
`source/kernel.cc:87-187`) to get Green's-function gradients for stress
recovery and (experimental) hypersingular work.  The torch kernels of
`kernels.stokeslet` are differentiable, so the AD family is forward-mode
Jacobians (`torch.func.jacfwd` under `torch.func.vmap`) — no duplicated
kernel code.  `kernels/helpers.py` keeps the closed-form Stokeslet stress it
equals (`stokeslet_stress` below is that identity's other side).

Conventions: gradients are with respect to the separation vector p = x - y;
output index order is value indices first, derivative index last
(`grad_G[..., i, j, k] = d G_ij / d p_k`), matching the reference's
`gradient_tens` layout.
"""

from __future__ import annotations

import math

import torch

from .stokeslet import stokeslet_G, stresslet_W


def _jac(fn):
    """Batched forward-mode Jacobian over the trailing [dim] vector axis."""

    def wrapped(p: torch.Tensor, *args, **kwargs):
        single = torch.func.jacfwd(lambda q: fn(q, *args, **kwargs))
        flat = p.reshape(-1, p.shape[-1])
        out = torch.func.vmap(single)(flat)
        return out.reshape(p.shape[:-1] + out.shape[1:])

    return wrapped


grad_stokeslet_G = _jac(stokeslet_G)
"""d G_ij / d p_k -> [..., dim, dim, dim] (reference gradient_tens of the
rank-2 Sacado kernel)."""

grad_stresslet_W = _jac(stresslet_W)
"""d W_ijk / d p_l -> [..., dim, dim, dim, dim]."""


def stokeslet_pressure(p: torch.Tensor) -> torch.Tensor:
    """Pressure vector of the Stokeslet, P_j = p_j / (4 pi R^3) (3D) — the
    companion field needed to assemble the Stokeslet's Cauchy stress."""
    dim = p.shape[-1]
    R = torch.sqrt(torch.sum(p * p, dim=-1))
    if dim == 2:
        return p / (2.0 * math.pi * (R * R)[..., None])
    return p / (4.0 * math.pi * (R * R * R)[..., None])


def stokeslet_stress(p: torch.Tensor) -> torch.Tensor:
    """Cauchy stress tensor of the Stokeslet column fields,
    sigma_ijk = -delta_ij P_k + (dG_ik/dp_j + dG_jk/dp_i)  (mu = 1):
    index k is the Stokeslet direction; it equals the stresslet
    sigma_ijk = W_kij = -3 p_i p_j p_k / (4 pi R^5) in 3D."""
    dim = p.shape[-1]
    gG = grad_stokeslet_G(p)  # [..., i, k, j] = dG_ik/dp_j
    P = stokeslet_pressure(p)
    eye = torch.eye(dim, dtype=p.dtype, device=p.device)
    sym = torch.swapaxes(gG, -1, -2)  # [..., i, j, k] = dG_ik/dp_j
    sig = sym + torch.swapaxes(sym, -3, -2)  # + dG_jk/dp_i
    return sig - eye[..., :, :, None] * P[..., None, None, :]
