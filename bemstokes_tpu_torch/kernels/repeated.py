"""Periodic (repeated-image) Stokes kernels (port of
`bemstokes_tpu/kernels/repeated.py`).

The reference ships a machine-generated, fully unrolled 21-image periodic
Stokeslet/stresslet (`include/repeated_kernel.h:28-42`,
`source/repeated_kernel.cc:13-3782`, 3D only, images at -10h..+10h along y;
compiled but referenced nowhere else).  Here it is the free-space kernel
summed over a static image lattice, a [n_images] batch axis.
"""

from __future__ import annotations

import torch

from .stokeslet import stokeslet_G, stresslet_W, stokeslet_G_Wn


def _image_offsets(p, h: float, axis: int, n_images: int):
    """[2*n_images+1, dim] lattice offsets k*h along `axis` (k = -n..n)."""
    dim = p.shape[-1]
    k = torch.arange(-n_images, n_images + 1, dtype=p.dtype, device=p.device)
    offs = torch.zeros((2 * n_images + 1, dim), dtype=p.dtype, device=p.device)
    offs[:, axis] = k * h
    return offs


def repeated_G(p: torch.Tensor, h: float, axis: int = 1, n_images: int = 10) -> torch.Tensor:
    """Periodic single-layer kernel: sum of Stokeslets at p + k*h*e_axis
    (reference `RepeatedStokesKernel::value_tens`). p[..., d] -> [..., d, d]."""
    pk = p[..., None, :] + _image_offsets(p, h, axis, n_images)  # [..., ni, d]
    return stokeslet_G(pk).sum(dim=-3)


def repeated_W(p: torch.Tensor, h: float, axis: int = 1, n_images: int = 10) -> torch.Tensor:
    """Periodic double-layer kernel (reference
    `RepeatedStokesKernel::value_tens2`). p[..., d] -> [..., d, d, d]."""
    pk = p[..., None, :] + _image_offsets(p, h, axis, n_images)
    return stresslet_W(pk).sum(dim=-4)


def repeated_G_Wn(p: torch.Tensor, n: torch.Tensor, h: float, axis: int = 1, n_images: int = 10):
    """Fused periodic (G, W . n)."""
    pk = p[..., None, :] + _image_offsets(p, h, axis, n_images)
    G, Wn = stokeslet_G_Wn(pk, n[..., None, :])
    return G.sum(dim=-3), Wn.sum(dim=-3)
