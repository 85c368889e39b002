"""The arithmetic of the LU apply kernel (`bemstokes_tpu_torch/csrc/lu_trsv.cu`)
on the CPU, without a card.

The CUDA source is compiled with g++ against the stub `cuda_runtime.h` of
`test_torch_node_sweep_emulation.py` (qualifiers empty, `__shared__` a static
local, a block's threads as host threads meeting at `__syncthreads()`, each
`<<<>>>` launch rewritten into a loop over the grid's blocks), with the
ticket's atomic and the (value, launch) words added and `-DLU_TRSV_HOST_EMULATION`:
the global loads are plain, the asynchronous copy of a diagonal inverse a
byte copy, and a wait for a published value checks once.  The plan runs one
block (`grid=1`), which takes every work item in ticket order, so each
value must be published before it is read: the launch returns an error where
one is not.  Built with `-ffp-contract=off` and the kernel's explicit fma,
the host computes what the card does, in the same order.

Held against `torch.linalg.solve_triangular` of the same factor with the
kept permutation (`la.direct.lu_apply` without a plan), relative to
max|x|: 1e-12 in float64 and 1e-5 in float32, on seeded matrices whose
factorization pivots (rows of a well-conditioned L U in a random order),
n from 1 to 1,000 around the tile edge, with a fresh right-hand side, a row
of a larger tensor, a column [n, 1] of a wider one; the plan's scratch
reused over launches, two solves with the same bits, and a refactor onto
other pivots.  One triangle a launch (`solve_triangle`) in both layouts:
the factor column-major as lu_factor leaves it, and row-major as diagonal
block 1 of a [n, 4n] slab (the distributed slab LU's rows, NaN everywhere
outside the block so that a read past it shows), against `solve_triangular`
on a contiguous copy; and the slab LU's apply at world size 1 through the
plan.  Skips where no g++ is
found.  The `cuda` tests run the card's build at the same tolerances (the
row-major slab blocks too, with no host sync and the same bits over
repeated launches), and the full grid at 23,101 unknowns over many launches
for the same bits each time.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from bemstokes_tpu_torch.la.direct import lu_apply, pivots_to_permutation
from bemstokes_tpu_torch.ops import lu_trsv
from bemstokes_tpu_torch.utils import timers
from test_torch_node_sweep_emulation import CSRC, STUB, _host_source
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
T = lu_trsv.TILE
SIZES = [1, T - 1, T, T + 1, 3 * T + 5, 1000]

#: what the persistent grid adds to the node sweeps' stub
STUB_GRID = r"""
#define __align__(n) __attribute__((aligned(n)))
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
struct alignas(16) double2 { double x, y; };
struct alignas(8) float2 { float x, y; };
inline double __longlong_as_double(long long v) { double d; std::memcpy(&d, &v, 8); return d; }
inline long long __double_as_longlong(double d) { long long v; std::memcpy(&v, &d, 8); return v; }
inline float __int_as_float(int v) { float f; std::memcpy(&f, &v, 4); return f; }
inline int __float_as_int(float f) { int v; std::memcpy(&v, &f, 4); return v; }
// a warp shuffle: every thread of the block takes part (the kernel shuffles
// only where the whole block does), each reads the slot of its source lane
template <typename T> inline T __shfl_sync(unsigned, T v, int src) {
  static T slot[1024];
  const unsigned tid = threadIdx.x;
  slot[tid] = v;
  __syncthreads();
  const T out = slot[(tid & ~31u) | (unsigned(src) & 31u)];
  __syncthreads();
  return out;
}
template <typename T> inline T __shfl_xor_sync(unsigned mask, T v, int lanes) {
  return __shfl_sync(mask, v, int(threadIdx.x & 31u) ^ lanes);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/lu_trsv.cu built with g++ for the host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    tmp = tmp_path_factory.mktemp("lu_trsv_host")
    (tmp / "cuda_runtime.h").write_text(STUB + STUB_GRID)
    src = tmp / "lu_trsv.cpp"
    src.write_text(_host_source((CSRC / "lu_trsv.cu").read_text()))
    out = tmp / "liblu_trsv.so"
    cmd = [
        shutil.which("g++"), "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-ffp-contract=off",
        "-DLU_TRSV_HOST_EMULATION", f"-I{tmp}", "-o", str(out), str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, f"g++ failed on lu_trsv.cu:\n{proc.stderr}"
    lib = ctypes.CDLL(str(out))
    lu_trsv.declare(lib)
    return lib


def factor(n, seed, dtype):
    """(lu, perm) of a seeded matrix P L U whose factorization swaps rows:
    P a random permutation, L unit-lower and U upper with off-diagonal
    entries below 1 / sqrt(n) and U's diagonal in [1, 4], so partial
    pivoting finds P again and both triangles are well conditioned (the
    two routes then differ by rounding, not by amplified rounding);
    factored in float64 and cast, column-major as lu_factor leaves it."""
    g = torch.Generator().manual_seed(seed)
    off = 1 / max(n, 1) ** 0.5
    L = torch.eye(n, dtype=torch.float64) + torch.tril(torch.rand(n, n, generator=g, dtype=torch.float64) * 2 - 1, -1) * off
    U = torch.triu(torch.rand(n, n, generator=g, dtype=torch.float64) * 2 - 1, 1) * off
    U += torch.diag(1 + 3 * torch.rand(n, generator=g, dtype=torch.float64))
    A = (L @ U)[torch.randperm(n, generator=g)]
    lu, piv = torch.linalg.lu_factor(A)
    lu = lu.to(dtype).mT.contiguous().mT
    return lu, pivots_to_permutation(piv)


def rhs(n, seed, dtype, form):
    """A right-hand side [n] ("fresh"), a row of a [3, n] tensor ("row") or
    the middle column [n, 1] of an [n, 3] one ("column")."""
    g = torch.Generator().manual_seed(seed)
    if form == "fresh":
        return torch.randn(n, generator=g, dtype=torch.float64).to(dtype)
    if form == "row":
        return torch.randn(3, n, generator=g, dtype=torch.float64).to(dtype)[1]
    return torch.randn(n, 3, generator=g, dtype=torch.float64).to(dtype)[:, 1:2]


def rel(x, ref):
    return ((x - ref).abs().max() / ref.abs().max()).item()


#: the slab blocks' leading dimension over n, and the block the factor is
SLAB_RANKS = 4
SLAB_BLOCK = 1


def slab_block(lu, device=None):
    """The factor's values as diagonal block SLAB_BLOCK of a row-major
    [n, 4n] slab (strides (4n, 1)) on `device`, NaN elsewhere in the slab."""
    n = lu.shape[0]
    k = slice(SLAB_BLOCK * n, (SLAB_BLOCK + 1) * n)
    slab = torch.full((n, SLAB_RANKS * n), float("nan"), dtype=lu.dtype, device=device)
    slab[:, k] = lu
    assert torch.equal(slab[:, k].cpu(), lu)
    return slab[:, k]


def triangle_ref(lu, b, upper):
    col = b if b.ndim == 2 else b[:, None]
    x = torch.linalg.solve_triangular(lu.contiguous(), col, upper=upper, unitriangular=not upper)
    return x.reshape(b.shape)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", SIZES)
def test_kernel_matches_solve_triangular(lib, n, dtype):
    lu, perm = factor(n, seed=n, dtype=dtype)
    if n > 1:
        assert not torch.equal(perm, torch.arange(n)), "the factorization should pivot"
    plan = lu_trsv.TrsvPlan(lu, grid=1)
    assert plan.steps == -(-n // T) and plan.items == int(lu_trsv.step_items(torch.arange(plan.steps)).sum())
    assert plan.step_start.tolist()[-1] == plan.items
    for k, form in enumerate(("fresh", "row", "column", "fresh")):
        b = rhs(n, seed=100 * n + k, dtype=dtype, form=form)
        x = plan.solve(perm, b, lib=lib)
        ref = lu_apply(lu, perm, b)
        assert x.shape == b.shape and x.dtype == dtype
        assert rel(x, ref) <= TOL[dtype], (form, rel(x, ref))
    # launches reuse the scratch: the same bits again, two launches a solve
    assert plan.launch == 8
    assert torch.equal(plan.solve(perm, b, lib=lib), x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("layout", ["row", "col"])
def test_kernel_solves_one_triangle_in_place(lib, layout, n, dtype):
    """One triangle a launch, the factor read where it lies: column-major
    as lu_factor leaves it, or row-major as a diagonal block of a slab at
    ld = 4n; L (unit lower) and U against `solve_triangular` on a contiguous
    copy; the plan picks the layout from the strides."""
    lu, perm = factor(n, seed=n + 1, dtype=dtype)
    block = slab_block(lu) if layout == "row" else lu
    plan = lu_trsv.TrsvPlan(block, grid=1)
    assert plan.row_major == (layout == "row")
    assert plan.ld == (SLAB_RANKS * n if layout == "row" else n)
    for k, form in enumerate(("fresh", "row", "column")):
        b = rhs(n, seed=200 * n + k, dtype=dtype, form=form)
        for upper in (False, True):
            x = plan.solve_triangle(upper, b, lib=lib)
            ref = triangle_ref(lu, b, upper)
            assert x.shape == b.shape and x.dtype == dtype
            assert rel(x, ref) <= TOL[dtype], (form, upper, rel(x, ref))
    # the apply through both launches, and the same bits again
    b = rhs(n, seed=7 * n, dtype=dtype, form="fresh")
    x = plan.solve(perm, b, lib=lib)
    assert rel(x, lu_apply(lu, perm, b)) <= TOL[dtype]
    assert torch.equal(plan.solve(perm, b, lib=lib), x)
    assert plan.launch == 2 * 3 + 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_slab_apply_solves_its_triangles_through_the_plan(lib, dtype, monkeypatch):
    """The slab LU's apply at world size 1 (the whole factor one rank's row
    slab, row-major) with the kernel's plan: each sweep's triangle through
    `solve_triangle`, counted `slab triangles native`, as `solve_triangular`
    solves it; several right-hand sides keep `solve_triangular`."""
    from bemstokes_tpu_torch.parallel.lu import slab_lu_factor, slab_lu_solve
    from bemstokes_tpu_torch.parallel.sharded import RowMesh

    monkeypatch.setattr(lu_trsv, "_library", lambda: lib)
    n = 3 * T + 5
    mesh = RowMesh(group=None, rank=0, world=1, device=torch.device("cpu"))
    g = torch.Generator().manual_seed(9)
    A = torch.randn(n, n, generator=g, dtype=torch.float64) / n**0.5 + 4 * torch.eye(n, dtype=torch.float64)
    LU, perm, plan = slab_lu_factor(A.to(dtype), mesh)
    assert LU.stride() == (n, 1)
    assert plan is None  # on the CPU
    plan = lu_trsv.TrsvPlan(LU, grid=1)
    assert plan.row_major
    b = torch.randn(n, generator=g, dtype=torch.float64)
    timers.reset()
    try:
        x = slab_lu_solve(LU, perm, b, mesh, plan)
        assert timers.counts["slab triangles native"] == 2
        ref = slab_lu_solve(LU, perm, b, mesh, None)
        assert timers.counts["slab triangles native"] == 2
        assert x.dtype == b.dtype and rel(x, ref) <= TOL[dtype]
        B = torch.randn(n, 3, generator=g, dtype=torch.float64)
        assert torch.equal(slab_lu_solve(LU, perm, B, mesh, plan), slab_lu_solve(LU, perm, B, mesh, None))
        assert timers.counts["slab triangles native"] == 2
    finally:
        timers.reset()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_after_a_refactor_onto_other_pivots(lib, dtype):
    n = 3 * T + 5
    b = rhs(n, seed=7, dtype=dtype, form="fresh")
    for seed in (11, 12):
        lu, perm = factor(n, seed=seed, dtype=dtype)
        plan = lu_trsv.TrsvPlan(lu, grid=1)
        x = plan.solve(perm, b, lib=lib)
        assert rel(x, lu_apply(lu, perm, b)) <= TOL[dtype]
        perms = perm if seed == 11 else (perms, perm)
    assert not torch.equal(*perms)


def test_diagonal_inverses_pad_the_last_block_with_the_identity():
    n = 2 * T + 3
    lu, _ = factor(n, seed=3, dtype=torch.float64)
    L_inv = lu_trsv.diagonal_inverses(lu, upper=False)
    U_inv = lu_trsv.diagonal_inverses(lu, upper=True)
    assert L_inv.shape == U_inv.shape == (3, T, T)
    for k in range(3):
        rows = slice(k * T, min(n, (k + 1) * T))
        m = rows.stop - rows.start
        D = lu[rows, rows]
        L = torch.tril(D, -1) + torch.eye(m, dtype=D.dtype)
        U = torch.triu(D)
        # stored column by column: [k, c, r]
        assert torch.allclose(L_inv[k].mT[:m, :m] @ L, torch.eye(m, dtype=D.dtype), atol=1e-13)
        assert torch.allclose(U_inv[k].mT[:m, :m] @ U, torch.eye(m, dtype=D.dtype), atol=1e-12)
    assert torch.equal(L_inv[2].mT[3:, 3:], torch.eye(T - 3, dtype=torch.float64))
    assert torch.equal(U_inv[2].mT[3:, :3], torch.zeros(T - 3, 3, dtype=torch.float64))


@pytest.mark.parametrize("upper", [False, True], ids=["L", "U"])
def test_coupling_tiles_are_the_inverse_times_the_previous_steps_tile(upper):
    n = 3 * T + 5
    lu, _ = factor(n, seed=4, dtype=torch.float64)
    dinv = lu_trsv.diagonal_inverses(lu, upper)
    M = lu_trsv.coupling_tiles(lu, dinv, upper)
    assert M.shape == (4, T, T)
    blocks = [slice(k * T, min(n, (k + 1) * T)) for k in range(4)]
    for R in range(4):
        C = R + 1 if upper else R - 1
        if not 0 <= C < 4:  # the block row solved first has none
            assert torch.equal(M[R], torch.zeros(T, T, dtype=torch.float64))
            continue
        rows, cols = blocks[R], blocks[C]
        m, c = rows.stop - rows.start, cols.stop - cols.start
        expect = dinv[R].mT[:m, :m] @ lu[rows, cols]
        assert torch.allclose(M[R].mT[:m, :c], expect, rtol=0, atol=1e-13)
        assert not M[R].mT[m:].any() and not M[R].mT[:, c:].any()


@pytest.mark.parametrize("field", ["steps", "items"])
def test_kernel_refuses_a_bad_launch(lib, field):
    """A plan whose steps are not ceil(n / TILE), or whose item count is
    not the source's split of them, is refused before any block runs."""
    lu, perm = factor(3 * T + 5, seed=5, dtype=torch.float64)
    plan = lu_trsv.TrsvPlan(lu, grid=1)
    b = rhs(3 * T + 5, seed=5, dtype=torch.float64, form="fresh")
    setattr(plan, field, getattr(plan, field) + 1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        plan.solve(perm, b, lib=lib)


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, T + 1, 1000, 4097])
def test_card_kernel_matches_solve_triangular(cuda_device, n, dtype):
    """The card's build through the plan, held like the host build; no
    host sync in the apply; a factor the kernel cannot read raises."""
    lu, perm = factor(n, seed=n, dtype=dtype)
    lu, perm = lu.to(cuda_device).mT.contiguous().mT, perm.to(cuda_device)
    plan = lu_trsv.plan(lu)
    before = lu_trsv.launches
    for k, form in enumerate(("fresh", "row", "column")):
        b = rhs(n, seed=100 * n + k, dtype=dtype, form=form).to(cuda_device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            x = plan.solve(perm, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = lu_apply(lu, perm, b)
        assert x.shape == b.shape and rel(x, ref) <= TOL[dtype], (form, rel(x, ref))
        assert torch.equal(plan.solve(perm, b), x)
    assert lu_trsv.launches == before + 12
    # the same factor row-major: read in place, as lu_apply solves it
    row = lu_trsv.plan(lu.contiguous())
    assert row.row_major == (n > 1) and row.ld == n
    b = rhs(n, seed=3 * n, dtype=dtype, form="fresh").to(cuda_device)
    assert rel(row.solve(perm, b), lu_apply(lu, perm, b)) <= TOL[dtype]
    if n > 1:
        with pytest.raises(ValueError, match="ld >= "):
            lu_trsv.plan(lu.contiguous()[::2, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, T + 1, 1000, 4097])
def test_card_kernel_reads_a_row_major_slab_block(cuda_device, n, dtype):
    """The card's build on diagonal block 1 of a row-major [n, 4n] slab
    (NaN elsewhere): each triangle as `solve_triangular` solves a
    contiguous copy, no host sync, the same bits over repeated launches."""
    lu, _ = factor(n, seed=n + 1, dtype=dtype)
    block = slab_block(lu, cuda_device)
    lu = lu.to(cuda_device)
    plan = lu_trsv.plan(block)
    assert plan.row_major and plan.ld == SLAB_RANKS * n
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert plan.grid == sms * lu_trsv.ROW_MAJOR_BLOCKS_PER_SM
    for k, form in enumerate(("fresh", "row", "column")):
        b = rhs(n, seed=200 * n + k, dtype=dtype, form=form).to(cuda_device)
        for upper in (False, True):
            torch.cuda.set_sync_debug_mode("error")
            try:
                xs = [plan.solve_triangle(upper, b) for _ in range(5)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ref = triangle_ref(lu, b, upper)
            assert xs[0].shape == b.shape and rel(xs[0], ref) <= TOL[dtype], (form, upper, rel(xs[0], ref))
            assert all(torch.equal(x, xs[0]) for x in xs[1:])


#: the stress test's size: the bacterium's 23,101 unknowns, the grid
#: every multiprocessor's persistent blocks
STRESS_N = 23101
STRESS_APPLIES = 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_card_kernel_same_bits_over_many_launches_at_full_width(cuda_device, dtype):
    """The full persistent grid at 23,101 unknowns: every launch of many
    hands its values between blocks anew (the tagged words are reused from
    launch to launch) and must give the same bits, for the same and for
    alternating right-hand sides, and agree with `solve_triangular`.  The
    matrix is a row permutation of I + a random 1 / sqrt(n)-scaled part, so
    the factor pivots and both triangles are well conditioned."""
    n = STRESS_N
    g = torch.Generator(device=cuda_device).manual_seed(22)
    A = torch.randn(n, n, generator=g, device=cuda_device, dtype=torch.float64).div_(n**0.5)
    A.diagonal().add_(4.0)
    A = A[torch.randperm(n, generator=g, device=cuda_device)]
    lu, piv = torch.linalg.lu_factor(A)
    del A
    lu = lu.mT.to(dtype).mT
    perm = pivots_to_permutation(piv)
    assert lu.stride() == (1, n) and not torch.equal(perm, torch.arange(n, device=cuda_device))
    plan = lu_trsv.plan(lu)
    assert plan.grid == torch.cuda.get_device_properties(cuda_device).multi_processor_count * lu_trsv.BLOCKS_PER_SM
    bs = [torch.randn(n, generator=g, device=cuda_device, dtype=torch.float64).to(dtype) for _ in range(2)]
    first = [plan.solve(perm, b) for b in bs]
    for x, b in zip(first, bs):
        assert rel(x, lu_apply(lu, perm, b)) <= TOL[dtype]
    same = [torch.equal(plan.solve(perm, bs[k % 2]), first[k % 2]) for k in range(STRESS_APPLIES)]
    assert all(same), f"{same.count(False)} of {STRESS_APPLIES} applies changed bits"
