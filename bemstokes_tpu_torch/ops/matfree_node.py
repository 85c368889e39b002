"""K5, the assembly-fused sweep-matvec: the actions (V @ XV, K @ XK) of the
smooth-rule bulk operators computed inside the pairwise node sweep, so that
V and K are never formed (port of `bemstokes_tpu/ops/matfree_node.py`;
reference hot loop `source/bem_stokes.cc:2915-2949`, matvec use `:4332`).

The CUDA kernel `csrc/sweep_matvec.cu` replaces the Pallas TPU kernel
`bemstokes_tpu/ops/matfree_node.py:195` `_matvec_kernel` for the free-space,
free-surface and Blake no-slip Green's functions, in float32 and float64;
its source carries the note on what bounds it and what its design does.
`sweep_matvec_reference` is the plain torch version, modelled on the JAX
package's `_sweep_matvec_xla`.

Semantics are those of the materialized node sweep (`ops/node_kernel.py`):
the same sample tables, the same dummy offset on exact r^2 = 0 pairs, so the
singular delta COO cancels them.

Launch shapes: the batch widths pick the kernel's instantiation
(`launch_shape`): one column each of V and K, one column of V alone (the
GMRES matvec of an all-body mesh, `matfree.py`), one of K alone, or chunks
of four columns for anything wider (the setup sweep).

What the TPU kernel needed and this one does not: the repeat of every node
value over its samples (`_prep_x`), the ones-matrix reduction, the padded
128-lane output with its 3 B <= 128 cap on the batch (any BV, BK >= 0 is
served here) and the f32-only rule (the sweep runs in the tables' dtype).
`cfg.matfree_backend`, `pallas_row_tile` and `pallas_col_chunk` stay accepted
config fields that nothing reads.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..kernels.images import image_point
from ..utils import timers
from . import cuda_build
from .assemble import AssemblyTables, node_column_samples
from .node_kernel import (
    KERNEL_FREE_SPACE,
    KERNEL_FREE_SURFACE,
    KERNEL_NO_SLIP,
    eval_G_Wn,
    refuse_plane,
)
from . import bulk_2d

SOURCE = cuda_build.CSRC / "sweep_matvec.cu"
# the `kind` argument of the library's entry points
_KIND = {KERNEL_FREE_SPACE: 0, KERNEL_FREE_SURFACE: 1, KERNEL_NO_SLIP: 2}

#: kernel launches made by `sweep_matvec`, per Green's function (plain
#: counters: set them to 0 before a run and read them after)
launches = {KERNEL_FREE_SPACE: 0, KERNEL_FREE_SURFACE: 0, KERNEL_NO_SLIP: 0}
#: the same launches per Green's function and launch shape (`launch_shape`)
shape_launches = {
    (kernel, shape): 0 for kernel in launches for shape in ("1x1", "1x0", "0x1", "wide")
}


def launch_shape(BV: int, BK: int) -> str:
    """Which of the kernel's instantiations serves a (BV, BK) batch: "1x1"
    (two-sided), "1x0" (V only), "0x1" (K only), or "wide" (chunks of four
    columns, each two-sided or one-sided as its columns are)."""
    return f"{BV}x{BK}" if BV <= 1 and BK <= 1 else "wide"


@dataclasses.dataclass(frozen=True)
class SweepStatic:
    """Static description of a fused matvec sweep."""

    d: int
    n: int  # column nodes
    nr: int  # collocation rows
    kernel: str
    wall_axis: int
    wall_position: float
    nq: int
    vmax: int
    dtype: torch.dtype


def sweep_static(tables: AssemblyTables, nr: int) -> SweepStatic:
    """Static sweep description from the (host) tables alone."""
    cfg = tables.cfg
    if cfg.kernel not in _KIND or (cfg.dim == 2 and cfg.kernel != KERNEL_FREE_SPACE):
        raise ValueError(f"no {cfg.dim}D sweep for kernel {cfg.kernel!r}")
    return SweepStatic(
        d=cfg.dim,
        n=tables.n_nodes,
        nr=nr,
        kernel=cfg.kernel,
        wall_axis=cfg.wall_axis,
        wall_position=cfg.wall_position,
        nq=len(tables.q_weights),
        vmax=tables.inc_slot.shape[1],
        dtype=cfg.dtype,
    )


def build_sweep_arrays(st: SweepStatic, tables, xi, xq, normals, jxw):
    """Per-frame sweep arrays for `sweep_matvec`.  xi [nr, d] collocation
    points; (xq, normals, jxw) the smooth-rule panel geometry (the same
    arrays the assembly pass uses)."""
    Yj, Nj, Wj, _, _ = node_column_samples(tables, xq, normals, jxw)
    return dict(
        xi=xi.to(st.dtype).contiguous(),
        Y=Yj.to(st.dtype).contiguous(),
        N=Nj.to(st.dtype).contiguous(),
        W=Wj.to(st.dtype).contiguous(),
    )


def sweep_matvec_2d(st: SweepStatic, arrs, XV, XK):
    """(V @ XV, K @ XK) of a 2D problem's smooth bulk: the plain torch of
    `ops/bulk_2d.py` on every device (K5 is 3D, as the JAX package's fused
    matvec is; its 2D action is the XLA `_sweep_matvec_xla`).  Arguments and
    results as `sweep_matvec`'s."""
    if st.d != 2:
        raise ValueError(f"sweep_matvec_2d: a {st.d}D sweep")
    squeeze_v, squeeze_k = XV.ndim == 1, XK.ndim == 1
    VX, KX = bulk_2d.sweep_matvec(
        arrs["xi"],
        arrs["Y"],
        arrs["N"],
        arrs["W"],
        XV[:, None] if squeeze_v else XV,
        XK[:, None] if squeeze_k else XK,
    )
    return VX[:, 0] if squeeze_v else VX, KX[:, 0] if squeeze_k else KX


def build_sweep(tables: AssemblyTables, xi, xq, normals, jxw):
    """Convenience: (SweepStatic, arrays) in one call."""
    st = sweep_static(tables, xi.shape[0])
    return st, build_sweep_arrays(st, tables, xi, xq, normals, jxw)


def declare(lib):
    """Argument and result types of the library's entry points."""
    lib.sweep_matvec_part_elems.argtypes = [ctypes.c_int64] * 4
    lib.sweep_matvec_part_elems.restype = ctypes.c_int64
    for name in ("sweep_matvec_f32", "sweep_matvec_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int64] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int


def _library():
    return cuda_build.library(SOURCE, declare)


def _check(st: SweepStatic, arrs, XV, XK):
    xi = arrs["xi"]
    refuse_plane("sweep_matvec", xi)
    m = st.vmax * st.nq
    shapes = {
        "xi": (xi, (st.nr, 3)),
        "Y": (arrs["Y"], (st.n, m, 3)),
        "N": (arrs["N"], (st.n, m, 3)),
        "W": (arrs["W"], (st.n, m)),
        "XV": (XV, (3 * st.n, XV.shape[1])),
        "XK": (XK, (3 * st.n, XK.shape[1])),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"sweep_matvec: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != st.dtype:
            raise TypeError(f"sweep_matvec: {name} is {t.dtype}, the sweep runs in {st.dtype}")
        if t.device != xi.device:
            raise ValueError(f"sweep_matvec: {name} is on {t.device}, xi on {xi.device}")
    if st.kernel != KERNEL_FREE_SPACE and st.wall_axis not in (0, 1, 2):
        raise ValueError(f"sweep_matvec: wall_axis must be 0, 1 or 2, got {st.wall_axis!r}")


def sweep_matvec(st: SweepStatic, arrs, XV, XK):
    """(V @ XV, K @ XK) of the smooth bulk pass.  XV [d*n, BV] and
    XK [d*n, BK] are component-blocked flat columns (any BV, BK >= 0);
    returns (VX [d*nr, BV], KX [d*nr, BK]).  1-D inputs are treated as
    single columns and returned 1-D.  A side of width 0 is not computed at
    all: (1, 0) and (0, 1) launch the kernel's one-sided instantiations.

    CUDA tensors launch the kernel K5 (float32 or float64) or raise; CPU
    tensors run `sweep_matvec_reference`.  The call is the span "Sweep
    matvec"."""
    squeeze_v = XV.ndim == 1
    squeeze_k = XK.ndim == 1
    if squeeze_v:
        XV = XV[:, None]
    if squeeze_k:
        XK = XK[:, None]
    _check(st, arrs, XV, XK)
    device = arrs["xi"].device
    with timers.span("Sweep matvec"):
        if device.type == "cpu":
            VX, KX = sweep_matvec_reference(st, arrs, XV, XK)
        elif device.type == "cuda":
            VX, KX = _sweep_matvec_cuda(st, arrs, XV, XK)
        else:
            raise ValueError(f"sweep_matvec: no kernel for device {device}")
    if squeeze_v:
        VX = VX[:, 0]
    if squeeze_k:
        KX = KX[:, 0]
    return VX, KX


def _sweep_matvec_cuda(st: SweepStatic, arrs, XV, XK):
    if st.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep_matvec: the kernel takes float32 or float64, got {st.dtype}")
    for name in ("xi", "Y", "N", "W"):
        if not arrs[name].is_contiguous():
            raise ValueError(f"sweep_matvec: {name} must be contiguous")
    XV, XK = XV.contiguous(), XK.contiguous()
    BV, BK = XV.shape[1], XK.shape[1]
    dev = arrs["xi"].device
    lib = _library()
    fn = lib.sweep_matvec_f64 if st.dtype == torch.float64 else lib.sweep_matvec_f32
    with torch.cuda.device(dev):
        VX = torch.empty((3 * st.nr, BV), dtype=st.dtype, device=dev)
        KX = torch.empty((3 * st.nr, BK), dtype=st.dtype, device=dev)
        if BV == 0 and BK == 0:
            return VX, KX
        part = torch.empty(
            (lib.sweep_matvec_part_elems(st.nr, st.n, BV, BK),), dtype=st.dtype, device=dev
        )
        rc = fn(
            arrs["xi"].data_ptr(),
            arrs["Y"].data_ptr(),
            arrs["N"].data_ptr(),
            arrs["W"].data_ptr(),
            XV.data_ptr(),
            XK.data_ptr(),
            VX.data_ptr(),
            KX.data_ptr(),
            part.data_ptr(),
            st.nr,
            st.n,
            st.vmax * st.nq,
            BV,
            BK,
            _KIND[st.kernel],
            int(st.wall_axis),
            float(st.wall_position),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sweep_matvec: {st.kernel} kernel launch failed with CUDA error {rc}")
    launches[st.kernel] += 1
    shape_launches[st.kernel, launch_shape(BV, BK)] += 1
    return VX, KX


def rsqrt_pos(x):
    """The kernel's float64 inverse square root (`rsqrt_pos` of
    `csrc/node_sweep_common.cuh`) of a contiguous CUDA tensor, alone: for the
    tests that hold it against 1 / sqrt."""
    if x.device.type != "cuda" or x.dtype != torch.float64 or not x.is_contiguous():
        raise ValueError("rsqrt_pos: takes a contiguous float64 CUDA tensor")
    lib = _library()
    fn = lib.sweep_matvec_rsqrt_f64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rsqrt_pos: kernel launch failed with CUDA error {rc}")
    return y


def sweep_matvec_reference(
    st: SweepStatic, arrs, XV, XK, row_tile: int = 32, col_chunk: int = 256
):
    """Plain torch version of K5: rows in tiles of `row_tile`, column nodes
    in chunks of `col_chunk`, each chunk's G and W.n evaluated by
    `eval_G_Wn` and contracted with the weights and the node values."""
    d, n, nr = st.d, st.n, st.nr
    xi, Yj, Nj, Wj = arrs["xi"], arrs["Y"], arrs["N"], arrs["W"]
    dt, dev = xi.dtype, xi.device
    BV, BK = XV.shape[1], XK.shape[1]
    XVn = XV.reshape(d, n, BV).permute(1, 2, 0)  # [n, BV, d]
    XKn = XK.reshape(d, n, BK).permute(1, 2, 0)
    oV = torch.zeros((nr, d, BV), dtype=dt, device=dev)
    oK = torch.zeros((nr, d, BK), dtype=dt, device=dev)
    ones = torch.ones((), dtype=dt, device=dev)
    image = st.kernel != KERNEL_FREE_SPACE
    for i0 in range(0, nr, row_tile):
        xi_t = xi[i0 : i0 + row_tile]
        if image:
            xi_img = image_point(xi_t, st.wall_axis, st.wall_position)
        for j0 in range(0, n, col_chunk):
            Ycc = Yj[j0 : j0 + col_chunk]
            R = Ycc[None, :, :, :] - xi_t[:, None, None, :]  # [t, cj, m, 3]
            r0mask = torch.sum(R * R, dim=-1, keepdim=True) == 0
            R = torch.where(r0mask, ones, R)
            if image:
                R_img = Ycc[None, :, :, :] - xi_img[:, None, None, :]
                R_img = torch.where(r0mask, ones, R_img)
            else:
                R_img = R
            G, Wn = eval_G_Wn(st.kernel, st.wall_axis, R, R_img, Nj[None, j0 : j0 + col_chunk])
            Wcc = Wj[j0 : j0 + col_chunk]
            if BV:
                oV[i0 : i0 + row_tile] += torch.einsum(
                    "tjmab,jm,jBb->taB", G, Wcc, XVn[j0 : j0 + col_chunk]
                )
            if BK:
                oK[i0 : i0 + row_tile] -= torch.einsum(
                    "tjmab,jm,jBb->taB", Wn, Wcc, XKn[j0 : j0 + col_chunk]
                )
    return (
        oV.permute(1, 0, 2).reshape(d * nr, BV),
        oK.permute(1, 0, 2).reshape(d * nr, BK),
    )
