"""The node sweeps K1, K2 and K3: the O(N^2) bulk of the dense V and K
operators, as CUDA kernels for Hopper beside their plain torch version.

They replace the Pallas TPU kernel `bemstokes_tpu/ops/pallas_node.py:129`
`_node_kernel_t`, one per value of its `kernel` argument:

- K1, `kernel="free_space"`: `csrc/node_sweep.cu`;
- K2, `kernel="free_surface"` (mirror image, wall-normal row sign) and
- K3, `kernel="no_slip"` (the Blake image system): `csrc/node_sweep_image.cu`.

Each kernel source carries the note on what bounds it on the card and what
its design does about that.  The TPU kernel's layout, tile and reduce knobs
(`pallas_row_tile`, `pallas_col_chunk`, `pallas_reduce`,
`BEMSTOKES_PALLAS_NODE_LAYOUT`, the rows-in-lanes twin `_node_kernel`) have
no meaning here: the CUDA kernels have one layout and write the dense
component-blocked operators directly.

`node_sweep(xi, Yj, Nj, Wj, kernel=...)` runs the kernel on CUDA tensors and
the plain version on CPU tensors; there is no fallback from one to the
other.  `ops/cuda_build.py` compiles each source with nvcc at first use and
loads it with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.images import free_surface_G_Wn, image_point, no_slip_wall_G, no_slip_wall_Wn
from ..kernels.stokeslet import stokeslet_G_Wn
from . import cuda_build

KERNEL_FREE_SPACE = "free_space"
KERNEL_FREE_SURFACE = "free_surface"  # reference reflect_kernel=true
KERNEL_NO_SLIP = "no_slip"  # reference no_slip_kernel=true

#: kernel -> the source that holds it
SOURCES = {
    KERNEL_FREE_SPACE: cuda_build.CSRC / "node_sweep.cu",
    KERNEL_FREE_SURFACE: cuda_build.CSRC / "node_sweep_image.cu",
    KERNEL_NO_SLIP: cuda_build.CSRC / "node_sweep_image.cu",
}
# the `kind` argument of the image library's entry points
_IMAGE_KIND = {KERNEL_FREE_SURFACE: 1, KERNEL_NO_SLIP: 2}

#: kernel launches made by `node_sweep`, per kernel (plain counters: set them
#: to 0 before a run and read them after to see that the run went through
#: the kernel)
launches = {KERNEL_FREE_SPACE: 0, KERNEL_FREE_SURFACE: 0, KERNEL_NO_SLIP: 0}


def _library(source):
    def declare(lib):
        head = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        if source == SOURCES[KERNEL_FREE_SPACE]:
            names, tail = ("node_sweep_f32", "node_sweep_f64"), []
        else:
            names = ("node_sweep_image_f32", "node_sweep_image_f64")
            tail = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = head + tail + [ctypes.c_void_p]
            fn.restype = ctypes.c_int

    return cuda_build.library(source, declare)


def _check_inputs(xi, Yj, Nj, Wj):
    nr, n, m = xi.shape[0], Yj.shape[0], Yj.shape[1]
    shapes = {
        "xi": (xi, (nr, 3)),
        "Yj": (Yj, (n, m, 3)),
        "Nj": (Nj, (n, m, 3)),
        "Wj": (Wj, (n, m)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"node_sweep: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != xi.dtype:
            raise TypeError(f"node_sweep: {name} is {t.dtype}, xi is {xi.dtype}")
        if t.device != xi.device:
            raise ValueError(f"node_sweep: {name} is on {t.device}, xi on {xi.device}")
    return nr, n, m


def _check_kernel(kernel, wall_axis):
    if kernel not in SOURCES:
        raise ValueError(f"node_sweep: unknown kernel {kernel!r}")
    if kernel != KERNEL_FREE_SPACE and wall_axis not in (0, 1, 2):
        raise ValueError(f"node_sweep: wall_axis must be 0, 1 or 2, got {wall_axis!r}")


def node_sweep(
    xi,
    Yj,
    Nj,
    Wj,
    kernel: str = KERNEL_FREE_SPACE,
    wall_axis: int = 1,
    wall_position: float = 0.0,
):
    """Dense (V, K) [3*nr, 3*n] of collocation rows xi [nr, 3] against the
    column-node sample tables Yj, Nj [n, m, 3], Wj [n, m] (from
    `ops.assemble.node_column_samples`), in the component-blocked layout
    (a*nr + i, b*n + j), for the free-space Green's functions or, with
    `kernel="free_surface"` / `"no_slip"`, the image system of the plane wall
    x[wall_axis] = wall_position.  Own-cell pairs are included with the
    smooth rule (the singular delta replaces them).

    A CUDA tensor launches the kernel K1, K2 or K3 (float32 or float64,
    contiguous inputs) or raises; a CPU tensor runs `node_sweep_reference`."""
    nr, n, m = _check_inputs(xi, Yj, Nj, Wj)
    _check_kernel(kernel, wall_axis)
    if xi.device.type == "cpu":
        return node_sweep_reference(
            xi, Yj, Nj, Wj, kernel=kernel, wall_axis=wall_axis, wall_position=wall_position
        )
    if xi.device.type != "cuda":
        raise ValueError(f"node_sweep: no kernel for device {xi.device}")
    if xi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node_sweep: the kernels take float32 or float64, got {xi.dtype}")
    for name, t in (("xi", xi), ("Yj", Yj), ("Nj", Nj), ("Wj", Wj)):
        if not t.is_contiguous():
            raise ValueError(f"node_sweep: {name} must be contiguous")
    suffix = "f64" if xi.dtype == torch.float64 else "f32"
    lib = _library(SOURCES[kernel])
    if kernel == KERNEL_FREE_SPACE:
        fn, extra = getattr(lib, f"node_sweep_{suffix}"), ()
    else:
        fn = getattr(lib, f"node_sweep_image_{suffix}")
        extra = (_IMAGE_KIND[kernel], int(wall_axis), float(wall_position))
    with torch.cuda.device(xi.device):
        V = torch.empty((3 * nr, 3 * n), dtype=xi.dtype, device=xi.device)
        K = torch.empty_like(V)
        rc = fn(
            xi.data_ptr(),
            Yj.data_ptr(),
            Nj.data_ptr(),
            Wj.data_ptr(),
            V.data_ptr(),
            K.data_ptr(),
            nr,
            n,
            m,
            *extra,
            torch.cuda.current_stream(xi.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"node_sweep: {kernel} kernel launch failed with CUDA error {rc}")
    launches[kernel] += 1
    return V, K


def eval_G_Wn(kernel: str, wall_axis: int, R, R_img, normals):
    """Kernel dispatch (G, W . n) with the normal contracted analytically
    (the JAX package's `ops/assemble.py:_eval_G_Wn`; reference
    compute_G_kernel / compute_W_kernel, `source/bem_stokes.cc:5028-5073`)."""
    if kernel == KERNEL_FREE_SPACE:
        return stokeslet_G_Wn(R, normals)
    if kernel == KERNEL_FREE_SURFACE:
        return free_surface_G_Wn(R, R_img, normals, wall_axis)
    if kernel == KERNEL_NO_SLIP:
        return (
            no_slip_wall_G(R, R_img, wall_axis),
            no_slip_wall_Wn(R, R_img, normals, wall_axis),
        )
    raise ValueError(kernel)


def node_sweep_reference(
    xi,
    Yj,
    Nj,
    Wj,
    row_tile: int = 32,
    col_chunk: int = 256,
    kernel: str = KERNEL_FREE_SPACE,
    wall_axis: int = 1,
    wall_position: float = 0.0,
):
    """Plain torch version of the K1, K2 and K3 kernels, modelled on the JAX
    package's XLA node pass (`bemstokes_tpu/ops/assemble.py:764-819`) and
    built on `kernels/stokeslet.py` and `kernels/images.py`: rows in tiles of
    `row_tile`, columns in chunks of `col_chunk`, so the pairwise
    intermediates stay [row_tile, col_chunk, m, 3, 3] (a single
    [nr, n, m, 3] tensor would be 58 GB at the 6,146-node sphere)."""
    nr, n, m = _check_inputs(xi, Yj, Nj, Wj)
    _check_kernel(kernel, wall_axis)
    dt, dev = xi.dtype, xi.device
    V = torch.empty((3, nr, 3, n), dtype=dt, device=dev)
    K = torch.empty((3, nr, 3, n), dtype=dt, device=dev)
    ones = torch.ones((), dtype=dt, device=dev)
    image = kernel != KERNEL_FREE_SPACE
    for i0 in range(0, nr, row_tile):
        xi_t = xi[i0 : i0 + row_tile]
        if image:
            xi_img = image_point(xi_t, wall_axis, wall_position)
        for j0 in range(0, n, col_chunk):
            Ycc = Yj[j0 : j0 + col_chunk]
            R = Ycc[None, :, :, :] - xi_t[:, None, None, :]  # [t, cj, m, 3]
            # exact R == 0 gets the dummy offset (1, 1, 1), on R and on its
            # image alike (so h0 reads 0 there); the singular delta subtracts
            # the same dummy value, so the pair cancels
            r0mask = torch.sum(R * R, dim=-1, keepdim=True) == 0
            R = torch.where(r0mask, ones, R)
            if image:
                R_img = Ycc[None, :, :, :] - xi_img[:, None, None, :]
                R_img = torch.where(r0mask, ones, R_img)
            else:
                R_img = R
            G, Wn = eval_G_Wn(kernel, wall_axis, R, R_img, Nj[None, j0 : j0 + col_chunk])
            Wcc = Wj[j0 : j0 + col_chunk]
            V[:, i0 : i0 + row_tile, :, j0 : j0 + col_chunk] = torch.einsum(
                "tjmab,jm->atbj", G, Wcc
            )
            K[:, i0 : i0 + row_tile, :, j0 : j0 + col_chunk] = -torch.einsum(
                "tjmab,jm->atbj", Wn, Wcc
            )
    return V.reshape(3 * nr, 3 * n), K.reshape(3 * nr, 3 * n)
