"""The slot kernel K6: the panel-centric body of the "gather" assembly, as a
CUDA kernel for Hopper beside its plain torch version.

It replaces the Pallas TPU kernel `bemstokes_tpu/ops/pallas_assemble.py:45`
`_kernel` (`pallas_tile_slots`, `:114`): the Green's functions once per
(collocation row, panel quadrature point), contracted over the panel's
points with the JxW-weighted shape values of its `nl` local nodes, own-cell
pairs masked by `keep`.  The result is a pair of slot tensors
`[Nc * nl, 9, T]` that the incidence gather-reduce of `ops.assemble` maps to
node columns.  `csrc/tile_slots.cu` carries the note on what bounds the
kernel on the card (its stores) and what its design does about that.

Unlike the TPU kernel the panels come unchunked and in the assembly's own
layouts (`xq`, `nrm` `[Nc, nq, 3]`, `wphi` `[Nc, nq, nl]`): the TPU kernel's
panel chunks `C`, its SoA transposes and the far-away padding points of a
ragged last chunk have no meaning here.

`tile_slots(xi, xq, nrm, wphi, keep)` runs the kernel on CUDA tensors and
`tile_slots_reference` on CPU tensors; there is no fallback from one to the
other.  `ops/cuda_build.py` compiles the source with nvcc at first use and
loads it with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.images import image_point
from . import cuda_build
from .node_kernel import KERNEL_FREE_SPACE, eval_G_Wn

SOURCE = cuda_build.CSRC / "tile_slots.cu"

#: kernel launches made by `tile_slots` (a plain counter: set it to 0 before
#: a run and read it after to see that the run went through the kernel)
launches = {"tile_slots": 0}


def _declare(lib):
    for name in ("tile_slots_f32", "tile_slots_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int


def _check_inputs(xi, xq, nrm, wphi, keep):
    nt, nc, nq = xi.shape[0], xq.shape[0], xq.shape[1]
    nl = wphi.shape[-1]
    shapes = {
        "xi": (xi, (nt, 3)),
        "xq": (xq, (nc, nq, 3)),
        "nrm": (nrm, (nc, nq, 3)),
        "wphi": (wphi, (nc, nq, nl)),
        "keep": (keep, (nc, nt)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"tile_slots: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != xi.dtype:
            raise TypeError(f"tile_slots: {name} is {t.dtype}, xi is {xi.dtype}")
        if t.device != xi.device:
            raise ValueError(f"tile_slots: {name} is on {t.device}, xi on {xi.device}")
    return nt, nc, nq, nl


def tile_slots(xi, xq, nrm, wphi, keep):
    """Free-space slot tensors (V_slots, K_slots) `[Nc * nl, 9, T]` of the
    collocation rows `xi [T, 3]` against every panel: quadrature points `xq`
    and unit normals `nrm` `[Nc, nq, 3]`, weighted shape values
    `wphi [Nc, nq, nl]` (JxW * phi), and `keep [Nc, T]`, 1 on smooth pairs
    and 0 where row t is a node of panel c.  Entry (c * nl + l, 3a + b, t).

    A CUDA tensor launches the kernel K6 (float32 or float64, contiguous
    inputs) or raises; a CPU tensor runs `tile_slots_reference`."""
    nt, nc, nq, nl = _check_inputs(xi, xq, nrm, wphi, keep)
    if xi.device.type == "cpu":
        return tile_slots_reference(xi, xq, nrm, wphi, keep)
    if xi.device.type != "cuda":
        raise ValueError(f"tile_slots: no kernel for device {xi.device}")
    if xi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tile_slots: the kernel takes float32 or float64, got {xi.dtype}")
    for name, t in (("xi", xi), ("xq", xq), ("nrm", nrm), ("wphi", wphi), ("keep", keep)):
        if not t.is_contiguous():
            raise ValueError(f"tile_slots: {name} must be contiguous")
    suffix = "f64" if xi.dtype == torch.float64 else "f32"
    fn = getattr(cuda_build.library(SOURCE, _declare), f"tile_slots_{suffix}")
    with torch.cuda.device(xi.device):
        V = torch.empty((nc * nl, 9, nt), dtype=xi.dtype, device=xi.device)
        K = torch.empty_like(V)
        rc = fn(
            xi.data_ptr(),
            xq.data_ptr(),
            nrm.data_ptr(),
            wphi.data_ptr(),
            keep.data_ptr(),
            V.data_ptr(),
            K.data_ptr(),
            nt,
            nc,
            nq,
            nl,
            torch.cuda.current_stream(xi.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_slots: kernel launch failed with CUDA error {rc}")
    launches["tile_slots"] += 1
    return V, K


def tile_slots_reference(
    xi,
    xq,
    nrm,
    wphi,
    keep,
    cell_chunk: int = 256,
    kernel: str = KERNEL_FREE_SPACE,
    wall_axis: int = 1,
    wall_position: float = 0.0,
):
    """Plain torch version of K6: the `pair_blocks` einsum of the JAX
    package (`bemstokes_tpu/ops/assemble.py:457-483`), panels in chunks of
    `cell_chunk` so the pairwise intermediates stay
    [T, cell_chunk, nq, 3, 3].  With `kernel="free_surface"` / `"no_slip"`
    it evaluates the image system of the plane wall x[wall_axis] =
    wall_position instead (the JAX package keeps those on its XLA path, and
    K6 is free space only)."""
    nt, nc, nq, nl = _check_inputs(xi, xq, nrm, wphi, keep)
    dt, dev = xi.dtype, xi.device
    V = torch.empty((nc, nl, 3, 3, nt), dtype=dt, device=dev)
    K = torch.empty_like(V)
    image = kernel != KERNEL_FREE_SPACE
    if image:
        xi_img = image_point(xi, wall_axis, wall_position)
    for c0 in range(0, nc, cell_chunk):
        c1 = min(c0 + cell_chunk, nc)
        sing = (keep[c0:c1] == 0).T[:, :, None, None]  # [T, cc, 1, 1]
        # masked pairs can hit R == 0 exactly (a row node on one of its own
        # panels): a dummy offset keeps them finite, `keep` zeroes them below
        R = xq[None, c0:c1] - xi[:, None, None, :]  # [T, cc, nq, 3]
        R = torch.where(sing, torch.ones_like(R), R)
        if image:
            R_img = xq[None, c0:c1] - xi_img[:, None, None, :]
            R_img = torch.where(sing, torch.ones_like(R_img), R_img)
        else:
            R_img = R
        G, Wn = eval_G_Wn(kernel, wall_axis, R, R_img, nrm[None, c0:c1])
        keep_c = keep[c0:c1, None, None, None, :]  # [cc, 1, 1, 1, T]
        V[c0:c1] = torch.einsum("tcqab,cql->clabt", G, wphi[c0:c1]) * keep_c
        # minus sign: exterior problem (reference `:2941-2947`)
        K[c0:c1] = -torch.einsum("tcqab,cql->clabt", Wn, wphi[c0:c1]) * keep_c
    return V.reshape(nc * nl, 9, nt), K.reshape(nc * nl, 9, nt)
