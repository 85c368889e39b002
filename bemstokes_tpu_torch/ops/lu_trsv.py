"""The two triangular solves of an LU apply for one right-hand side as one
hand-written CUDA kernel (`csrc/lu_trsv.cu`), launched once a triangle.

The kernel replaces no TPU kernel (the JAX package solves with XLA's
triangular solve); the source says what bounds it and how it streams each
triangle.  It reads the factor where it lies on the card and never copies
it: column-major, strides (1, n), as `torch.linalg.lu_factor` leaves it, or
row-major, strides (ld, 1) with ld >= n, as a rank's diagonal block of the
distributed slab LU lies in its rows (`parallel/lu.py`, ld = W m).

`plan(lu)` prepares a factor once a factorization: the inverse of each
TILE x TILE diagonal block of L and of U (`torch.linalg.solve_triangular`
against the identity) and that inverse times the block row's tile of the
step before it (`coupling_tiles`), the steps' first work items, and the
scratch the launches share (the published solution and partial products,
each value beside the launch that wrote it, and the ticket).
Nothing there reads the card back.  `TrsvPlan.solve(perm, b)` then solves
L U x = b[perm] with two launches, the output its one allocation (counter
`lu applies native`); `TrsvPlan.solve_triangle(upper, b)` solves one
triangle in one launch, with no gather (the slab LU's sweeps).  `plan`
returns None for a factor on the CPU, which keeps
`torch.linalg.solve_triangular`; a factor on the card that the kernel
cannot read (batched, no unit stride, a leading dimension below n or a
column-major one other than n, another dtype) raises there rather than leave
the kernel unused.
`ops/cuda_build.py` compiles the source with nvcc at first use and loads
it with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import timers
from . import cuda_build

SOURCE = cuda_build.CSRC / "lu_trsv.cu"
#: the tile edge, and the work items' split of a step (csrc/lu_trsv.cu TB,
#: SEG and OWNER, whose launch refuses an item count of another split):
#: each segment item streams SEGMENT_TILES off-diagonal tiles older than
#: the step's OWNER_TILES newest, which its owner item takes itself (the
#: newest through the coupling tile)
TILE = 64
SEGMENT_TILES = 32
OWNER_TILES = 3
#: persistent blocks an SM (csrc/lu_trsv.cu `__launch_bounds__`): two for a
#: column-major factor, one for a row-major one, which streams slower with
#: two (a triangle at m = 18,435 in f64: 0.66 ms with one, 0.75 with two)
BLOCKS_PER_SM = 2
ROW_MAJOR_BLOCKS_PER_SM = 1
DTYPES = (torch.float32, torch.float64)

#: kernel launches made by `TrsvPlan.solve` and `solve_triangle` (a plain
#: counter: two an apply, one a triangle)
launches = 0


def declare(lib):
    """Declare the C entry points `lu_trsv_f32` and `lu_trsv_f64`: (lu, ld,
    row_major, dinv, coupling, b, b_stride, perm, x, xt, partial, ticket,
    base, step_start, n, steps, upper, launch, items, grid, stream) -> CUDA
    error code."""
    for name in ("lu_trsv_f32", "lu_trsv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_void_p] * 3
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_int] * 2
            + [ctypes.c_uint32]
            + [ctypes.c_int] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int


def _library():
    return cuda_build.library(SOURCE, declare)


def plan(lu: torch.Tensor) -> TrsvPlan | None:
    """The kernel's plan of a factor on the card (raising where the kernel
    cannot read it); None on the CPU."""
    return TrsvPlan(lu) if lu.is_cuda else None


def diagonal_inverses(lu: torch.Tensor, upper: bool) -> torch.Tensor:
    """[N, TILE, TILE] inverses of the diagonal blocks of the unit-lower L
    (`upper` False) or of U, each stored column by column (entry (r, c) of
    block k at [k, c, r]); the last block, cut short by n, is padded with the
    identity."""
    n = lu.shape[0]
    full, rest = divmod(n, TILE)
    blocks = full + (rest > 0)
    eye = torch.eye(TILE, dtype=lu.dtype, device=lu.device)
    D = eye.repeat(blocks, 1, 1)
    s0, s1 = lu.stride()
    if full:
        D[:full] = lu.as_strided((full, TILE, TILE), (TILE * (s0 + s1), s0, s1), lu.storage_offset())
    if rest:
        D[full, :rest, :rest] = lu[full * TILE :, full * TILE :]
    X = torch.linalg.solve_triangular(D, eye.expand(blocks, TILE, TILE), upper=upper, unitriangular=not upper)
    return X.mT.contiguous()


def coupling_tiles(lu: torch.Tensor, dinv: torch.Tensor, upper: bool) -> torch.Tensor:
    """[N, TILE, TILE]: for each block row R, the inverse of its diagonal
    block (`dinv`, from `diagonal_inverses`) times its tile in the columns
    of the block solved just before it (R - 1 forward in L, R + 1 backward
    in U), stored column by column; zero where there is none.  The owner of
    a step then needs the previous step's solution for one product only."""
    n = lu.shape[0]
    full, rest = divmod(n, TILE)
    blocks = full + (rest > 0)
    T = torch.zeros(blocks, TILE, TILE, dtype=lu.dtype, device=lu.device)
    s0, s1 = lu.stride()
    if full > 1:  # the tiles whose rows and columns all lie inside the factor
        view = lu.as_strided(
            (full - 1, TILE, TILE), (TILE * (s0 + s1), s0, s1), lu.storage_offset() + TILE * (s1 if upper else s0)
        )
        T[slice(0, full - 1) if upper else slice(1, full)] = view
    if rest and full:  # the tile cut short by n
        edge = full * TILE
        if upper:
            T[full - 1, :, :rest] = lu[edge - TILE : edge, edge:]
        else:
            T[full, :rest] = lu[edge:, edge - TILE : edge]
    return (dinv.mT @ T).mT.contiguous()


def step_items(s: torch.Tensor) -> torch.Tensor:
    """Work items of each step s: one per SEGMENT_TILES of its off-diagonal
    tiles older than its OWNER_TILES newest, and its owner."""
    return (s - OWNER_TILES).clamp(min=0).add(SEGMENT_TILES - 1).div(SEGMENT_TILES, rounding_mode="floor") + 1


class TrsvPlan:
    """A factor's diagonal inverses and the scratch of its launches, made
    once a factorization; `solve` is one apply, `solve_triangle` one
    triangle.  The factor's strides pick the kernel's layout: (1, n)
    column-major, else (ld, 1) row-major.  `grid` (blocks a launch)
    defaults to BLOCKS_PER_SM (ROW_MAJOR_BLOCKS_PER_SM) a multiprocessor of
    the factor's card."""

    def __init__(self, lu: torch.Tensor, grid: int | None = None):
        if lu.ndim != 2 or lu.shape[0] != lu.shape[1]:
            raise ValueError(f"lu_trsv: takes one square factor, got shape {tuple(lu.shape)}")
        if lu.dtype not in DTYPES:
            raise TypeError(f"lu_trsv: takes float32 or float64, got {lu.dtype}")
        n = lu.shape[0]
        s0, s1 = lu.stride()
        if s0 == 1 and s1 == n:
            self.row_major, self.ld = False, n
        elif s1 == 1 and s0 >= n:
            self.row_major, self.ld = True, s0
        else:
            raise ValueError(
                f"lu_trsv: takes a column-major factor (strides (1, {n})) or a row-major one (strides (ld, 1), "
                f"ld >= {n}), got strides {lu.stride()}"
            )
        dev, dt = lu.device, lu.dtype
        if grid is None:
            per_sm = ROW_MAJOR_BLOCKS_PER_SM if self.row_major else BLOCKS_PER_SM
            grid = torch.cuda.get_device_properties(dev).multi_processor_count * per_sm
        self.lu, self.n, self.grid = lu, n, grid
        self.steps = -(-n // TILE)
        self.dinv = (diagonal_inverses(lu, False), diagonal_inverses(lu, True))
        self.coupling = tuple(coupling_tiles(lu, d, bool(u)) for u, d in enumerate(self.dinv))
        # the items' count on the host and their starts on the device, from
        # one rule, without a read back or an upload
        self.items = int(step_items(torch.arange(self.steps)).sum())
        self.step_start = torch.zeros(self.steps + 1, dtype=torch.int32, device=dev)
        self.step_start[1:] = torch.cumsum(step_items(torch.arange(self.steps, device=dev)), 0)
        # (value, launch) pairs: launch 0 marks a value no launch wrote
        self.xt = torch.zeros(2 * n, dtype=dt, device=dev)
        self.partial = torch.zeros(2 * self.items * TILE, dtype=dt, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int64, device=dev)
        self.y = torch.empty(n, dtype=dt, device=dev)
        self.base = 0
        self.launch = 0

    def _launch(self, lib, upper: bool, b, b_stride: int, perm, x):
        self.launch += 1
        fn = lib.lu_trsv_f64 if self.lu.dtype == torch.float64 else lib.lu_trsv_f32
        dev = self.lu.device
        stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
        rc = fn(
            self.lu.data_ptr(),
            self.ld,
            int(self.row_major),
            self.dinv[upper].data_ptr(),
            self.coupling[upper].data_ptr(),
            b.data_ptr(),
            b_stride,
            None if perm is None else perm.data_ptr(),
            x.data_ptr(),
            self.xt.data_ptr(),
            self.partial.data_ptr(),
            self.ticket.data_ptr(),
            self.base,
            self.step_start.data_ptr(),
            self.n,
            self.steps,
            int(upper),
            self.launch,
            self.items,
            self.grid,
            stream,
        )
        if rc != 0:
            raise RuntimeError(f"lu_trsv: kernel launch failed with CUDA error {rc}")
        # every block takes one ticket past the last item
        self.base += self.items + self.grid
        global launches
        launches += 1

    def _check(self, b: torch.Tensor):
        n = self.n
        if b.dtype != self.lu.dtype or b.device != self.lu.device:
            raise TypeError(f"lu_trsv: b is {b.dtype} on {b.device}, the factor {self.lu.dtype} on {self.lu.device}")
        if b.shape not in ((n,), (n, 1)):
            raise ValueError(f"lu_trsv: b must be [{n}] or [{n}, 1], got {tuple(b.shape)}")

    def solve(self, perm: torch.Tensor, b: torch.Tensor, lib=None) -> torch.Tensor:
        """x with L U x = b[perm], for b [n] or [n, 1] (any stride) of the
        factor's dtype and device and the kept permutation perm [n] (int64);
        x has b's shape.  Raises on any other b.  `lib` is the loaded kernel
        library (default: the card's build)."""
        self._check(b)
        n = self.n
        if perm.shape != (n,) or perm.dtype != torch.int64 or perm.device != b.device or not perm.is_contiguous():
            raise ValueError("lu_trsv: perm must be a contiguous int64 [n] on the factor's device")
        if lib is None:
            lib = _library()
        timers.count("lu applies native")
        x = torch.empty(b.shape, dtype=b.dtype, device=b.device)
        self._launch(lib, False, b, b.stride(0), perm, self.y)
        self._launch(lib, True, self.y, 1, None, x)
        return x

    def solve_triangle(self, upper: bool, b: torch.Tensor, lib=None) -> torch.Tensor:
        """x with L x = b (`upper` False: the unit-lower triangle) or U x = b,
        for b as `solve` takes it, in one launch and with no gather; x has
        b's shape and is the one allocation."""
        self._check(b)
        if lib is None:
            lib = _library()
        x = torch.empty(b.shape, dtype=b.dtype, device=b.device)
        self._launch(lib, bool(upper), b, b.stride(0), None, x)
        return x
