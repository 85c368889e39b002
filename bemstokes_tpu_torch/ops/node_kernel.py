"""The node sweeps K1, K2, K3 and K4: the O(N^2) bulk of the dense V and K
operators, as CUDA kernels for Hopper beside their plain torch version.

K1, K2 and K3 replace the Pallas TPU kernel
`bemstokes_tpu/ops/pallas_node.py:129` `_node_kernel_t`, one per value of its
`kernel` argument, and K4 its rows-in-lanes twin `:46` `_node_kernel`:

- K1, `kernel="free_space"`: `csrc/node_sweep.cu`;
- K2, `kernel="free_surface"` (mirror image, wall-normal row sign) and
- K3, `kernel="no_slip"` (the Blake image system): `csrc/node_sweep_image.cu`;
- K4, `kernel="free_space", layout="planes"`: K1's sums written
  component-major as `[9, n, nr]`, rows contiguous, a second instantiation
  in `csrc/node_sweep.cu` (free space only, like the TPU kernel).

Each kernel source carries the note on what bounds it on the card and what
its design does about that.  The TPU kernel's tile and reduce knobs
(`pallas_row_tile`, `pallas_col_chunk`, `pallas_reduce`) have no meaning
here, and its layout switch `BEMSTOKES_PALLAS_NODE_LAYOUT` is the explicit
`layout` argument: "dense" writes the component-blocked operators directly,
"planes" the component-major form.

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
from ..utils import timers
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
launches = {KERNEL_FREE_SPACE: 0, KERNEL_FREE_SURFACE: 0, KERNEL_NO_SLIP: 0, "planes": 0}
#: the (row, sample) interactions those launches swept, nr * n * m each, per
#: (counter of `launches`, "f32" or "f64"): launches of different shapes and
#: types are not worth the same, and this says what they were worth
interactions = {(key, suffix): 0 for key in launches for suffix in ("f32", "f64")}

LAYOUT_DENSE = "dense"  # [3 nr, 3 n], entry (a*nr + i, b*n + j)
LAYOUT_PLANES = "planes"  # [9, n, nr], entry (3a + b, j, i): K4


def declare(lib):
    """Declare the C entry points that a library built from
    `csrc/node_sweep.cu` (K1, K4) or `csrc/node_sweep_image.cu` (K2, K3)
    holds: (xi, Y, N, W, V, K, nr, n, m[, kind, wall_axis, wall_position],
    stream) -> CUDA error code."""
    head = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
    if hasattr(lib, "node_sweep_image_f64"):
        names = ("node_sweep_image_f32", "node_sweep_image_f64")
        tail = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
    else:
        names = ("node_sweep_f32", "node_sweep_f64", "node_sweep_planes_f32", "node_sweep_planes_f64")
        tail = []
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = head + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _library(source):
    return cuda_build.library(source, declare)


#: why the 3D sweeps refuse points of the plane (every CUDA wrapper of the
#: port raises with it on a 2D input, on every device)
PLANE_INPUT = (
    "takes points in 3D; a 2D problem's bulk and matvec are the plain torch "
    "of ops/bulk_2d.py, which ops.assemble.assemble_rows and "
    "matfree.MatfreeSolver choose by cfg.dim"
)


def refuse_plane(fn: str, x):
    """Raise when `x` holds points of the plane (a last axis of 2): the
    kernels are 3D, and a 2D input never runs their plain version either."""
    if x.shape[-1] == 2:
        raise ValueError(f"{fn} {PLANE_INPUT}")


def _check_inputs(xi, Yj, Nj, Wj):
    refuse_plane("node_sweep", xi)
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


def _check_kernel(kernel, wall_axis, layout=LAYOUT_DENSE):
    if kernel not in SOURCES:
        raise ValueError(f"node_sweep: unknown kernel {kernel!r}")
    if layout not in (LAYOUT_DENSE, LAYOUT_PLANES):
        raise ValueError(f"node_sweep: unknown layout {layout!r}")
    if layout == LAYOUT_PLANES and kernel != KERNEL_FREE_SPACE:
        raise ValueError(
            f"node_sweep: the planes layout is free space only, got kernel {kernel!r}"
        )
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
    layout: str = LAYOUT_DENSE,
):
    """Dense (V, K) [3*nr, 3*n] of collocation rows xi [nr, 3] against the
    column-node sample tables Yj, Nj [n, m, 3], Wj [n, m] (from
    `ops.assemble.node_column_samples`), in the component-blocked layout
    (a*nr + i, b*n + j), for the free-space Green's functions or, with
    `kernel="free_surface"` / `"no_slip"`, the image system of the plane wall
    x[wall_axis] = wall_position.  Own-cell pairs are included with the
    smooth rule (the singular delta replaces them).  With `layout="planes"`
    (free space only) the same sums come component-major as [9, n, nr],
    entry (3a + b, j, i), rows contiguous (`planes_to_dense` brings them to
    the dense form).

    A CUDA tensor launches the kernel K1, K2, K3 or K4 (float32 or float64,
    contiguous inputs) or raises; a CPU tensor runs `node_sweep_reference`.
    The call is the span "Node sweep"."""
    nr, n, m = _check_inputs(xi, Yj, Nj, Wj)
    _check_kernel(kernel, wall_axis, layout)
    with timers.span("Node sweep"):
        if xi.device.type == "cpu":
            return node_sweep_reference(
                xi,
                Yj,
                Nj,
                Wj,
                kernel=kernel,
                wall_axis=wall_axis,
                wall_position=wall_position,
                layout=layout,
            )
        return _node_sweep_cuda(xi, Yj, Nj, Wj, kernel, wall_axis, wall_position, layout, nr, n, m)


def _node_sweep_cuda(xi, Yj, Nj, Wj, kernel, wall_axis, wall_position, layout, nr, n, m):
    if xi.device.type != "cuda":
        raise ValueError(f"node_sweep: no kernel for device {xi.device}")
    if xi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"node_sweep: the kernels take float32 or float64, got {xi.dtype}")
    for name, t in (("xi", xi), ("Yj", Yj), ("Nj", Nj), ("Wj", Wj)):
        if not t.is_contiguous():
            raise ValueError(f"node_sweep: {name} must be contiguous")
    suffix = "f64" if xi.dtype == torch.float64 else "f32"
    lib = _library(SOURCES[kernel])
    planes = layout == LAYOUT_PLANES
    if planes:
        fn, extra = getattr(lib, f"node_sweep_planes_{suffix}"), ()
    elif kernel == KERNEL_FREE_SPACE:
        fn, extra = getattr(lib, f"node_sweep_{suffix}"), ()
    else:
        fn = getattr(lib, f"node_sweep_image_{suffix}")
        extra = (_IMAGE_KIND[kernel], int(wall_axis), float(wall_position))
    with torch.cuda.device(xi.device):
        shape = (9, n, nr) if planes else (3 * nr, 3 * n)
        V = torch.empty(shape, dtype=xi.dtype, device=xi.device)
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
    key = "planes" if planes else kernel
    launches[key] += 1
    interactions[key, suffix] += nr * n * m
    return V, K


def planes_to_dense(P):
    """Component-major planes [9, n, nr] as the dense component-blocked
    operator [3 nr, 3 n], entry (a*nr + i, b*n + j) (the `blocks_to_dense`
    relayout of `bemstokes_tpu/ops/assemble.py:743-753`)."""
    _, n, nr = P.shape
    return P.reshape(3, 3, n, nr).permute(0, 3, 1, 2).reshape(3 * nr, 3 * n)


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
    layout: str = LAYOUT_DENSE,
):
    """Plain torch version of the K1, K2, K3 and K4 kernels, modelled on the JAX
    package's XLA node pass (`bemstokes_tpu/ops/assemble.py:764-819`) and
    built on `kernels/stokeslet.py` and `kernels/images.py`: rows in tiles of
    `row_tile`, columns in chunks of `col_chunk`, so the pairwise
    intermediates stay [row_tile, col_chunk, m, 3, 3] (a single
    [nr, n, m, 3] tensor would be 58 GB at the 6,146-node sphere)."""
    nr, n, m = _check_inputs(xi, Yj, Nj, Wj)
    _check_kernel(kernel, wall_axis, layout)
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
    if layout == LAYOUT_PLANES:
        # [a, i, b, j] -> [3a + b, j, i]
        return (
            V.permute(0, 2, 3, 1).reshape(9, n, nr),
            K.permute(0, 2, 3, 1).reshape(9, n, nr),
        )
    return V.reshape(3 * nr, 3 * n), K.reshape(3 * nr, 3 * n)
