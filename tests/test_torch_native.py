"""The table half of the port's native binding (`bemstokes_tpu_torch/_native.py`:
`incidence_native`, `weld_native`, native/meshcore.cpp `mc_incidence`,
`mc_weld`) against the numpy loops and the JAX package's bindings, on
meshes built in code (the cases of tests/test_native.py), exact equality:
the C++ loops and the numpy ones do the same integer bookkeeping.  And
`build_assembly_tables`, which takes the native table first, gives the same
tables with the library and without it (BEMSTOKES_NATIVE=0).

The library is built once, by the port's loader under its lock on `native/`;
the JAX binding caches a failed load for the life of its process (a worker
that met the file mid-build keeps None), so each comparison resets that
cache first and loads the finished library."""

import fcntl
import os
import threading
import time

import numpy as np
import pytest

import bemstokes_tpu._native as native_j
import bemstokes_tpu_torch._native as native_t
from bemstokes_tpu_torch.mesh import build_scalar_space
from bemstokes_tpu_torch.mesh.factories import create_sphere, create_wall
from bemstokes_tpu_torch.mesh.refine import refine_uniform
from bemstokes_tpu_torch.ops.assemble import AssemblyConfig, build_assembly_tables
import torch_threads  # noqa: F401  (one torch thread a test process)


@pytest.fixture
def lib():
    if native_t.get_lib() is None:
        pytest.skip("native meshcore not buildable here (no make / g++)")
    return native_t.get_lib()


@pytest.fixture
def jax_native(lib, monkeypatch):
    """The JAX package's binding, loaded afresh from the library that `lib`
    built: its cached load state is reset for this test only."""
    for _ in range(20):
        monkeypatch.setattr(native_j, "_lib", None)
        monkeypatch.setattr(native_j, "_tried", False)
        if native_j.get_lib() is not None:
            return native_j
        time.sleep(0.5)  # another process's `make` may be rewriting the file
    pytest.fail("the JAX package's binding does not load the library the port built")


def numpy_incidence(cells, n):
    """The incidence loop of tests/test_native.py: node j's flat (cell,
    local) slots in increasing order, padded to the largest valence."""
    flat = np.asarray(cells).reshape(-1).astype(np.int64)
    counts = np.bincount(flat, minlength=n)
    vmax = max(int(counts.max()), 1)
    slots = np.zeros((n, vmax), np.int32)
    mask = np.zeros((n, vmax))
    fill = np.zeros(n, np.int64)
    for s, j in enumerate(flat):
        slots[j, fill[j]] = s
        mask[j, fill[j]] = 1.0
        fill[j] += 1
    return slots, mask


def _refined_wall():
    wall = create_wall((0.0, -2.0, 0.0), (2.0, 0.0, 2.0), refinements=2)
    return refine_uniform(wall, cell_filter=np.arange(wall.n_cells) < 3)


SPACES = {
    "random": None,
    "sphere2_q1": (lambda: create_sphere(refinements=2), 1),
    "sphere2_q2": (lambda: create_sphere(refinements=2), 2),
    "sphere2_q0": (lambda: create_sphere(refinements=2), 0),
    "refined_wall_q1": (_refined_wall, 1),
}


def _cells(name):
    if SPACES[name] is None:
        rng = np.random.default_rng(0)
        return rng.integers(0, 50, size=(120, 4)).astype(np.int32), 50, None
    make, degree = SPACES[name]
    space = build_scalar_space(make(), degree)
    return space.cells_nodes, space.n_nodes, space


@pytest.mark.parametrize("name", sorted(SPACES))
def test_incidence_native_matches_numpy_and_jax(lib, jax_native, name):
    cells, n, _ = _cells(name)
    slots, mask = native_t.incidence_native(cells, n)
    ref_slots, ref_mask = numpy_incidence(cells, n)
    assert slots.dtype == np.int32 and mask.dtype == np.float64
    np.testing.assert_array_equal(slots, ref_slots)
    np.testing.assert_array_equal(mask, ref_mask)
    jax_slots, jax_mask = jax_native.incidence_native(cells, n)
    np.testing.assert_array_equal(slots, jax_slots)
    np.testing.assert_array_equal(mask, jax_mask)


def test_incidence_native_rejects_out_of_range_nodes(lib):
    cells = np.array([[0, 1, 2, 7]], dtype=np.int32)
    assert native_t.incidence_native(cells, 4) is None


def test_weld_native(lib, jax_native):
    verts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 1e-15]])
    remap, n_unique = native_t.weld_native(verts, 1e-12)
    assert n_unique == 2
    assert remap[0] == remap[2] and remap[1] == remap[3] and remap[0] != remap[1]
    jr, jn = jax_native.weld_native(verts, 1e-12)
    np.testing.assert_array_equal(remap, jr)
    assert jn == n_unique


def test_weld_native_matches_merged_with(lib):
    """A sphere's vertices followed by copies of 40 of them, shifted by far
    less than the tolerance: the native remap is `SurfaceMesh.merged_with`'s
    numpy weld (the first occurrence keeps its place)."""
    sphere = create_sphere(refinements=2)
    rng = np.random.default_rng(3)
    extra = sphere.vertices[rng.permutation(sphere.n_vertices)[:40]] + 1e-14
    verts = np.concatenate([sphere.vertices, extra])
    remap, n_unique = native_t.weld_native(verts, 1e-10)
    rounded = np.round(verts / 1e-10).astype(np.int64)
    _, first, inverse = np.unique(rounded, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    np.testing.assert_array_equal(remap, rank[inverse.reshape(-1)])
    assert n_unique == sphere.n_vertices


@pytest.mark.parametrize("name", ["sphere2_q1", "sphere2_q2", "sphere2_q0", "refined_wall_q1"])
def test_assembly_tables_equal_with_and_without_the_library(lib, name, monkeypatch):
    _, _, space = _cells(name)
    cfg = AssemblyConfig(quad_order=4)
    with_lib = build_assembly_tables(space, space, cfg)
    monkeypatch.setenv("BEMSTOKES_NATIVE", "0")
    monkeypatch.setattr(native_t, "_lib", None)
    monkeypatch.setattr(native_t, "_tried", False)
    assert native_t.get_lib() is None
    without = build_assembly_tables(space, space, cfg)
    for key in ("inc_slot", "inc_mask", "cells_nodes_fe", "q_weights", "sq_weights"):
        a, b = getattr(with_lib, key), getattr(without, key)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_waits_for_the_lock(lib):
    """The port's `_build` takes the exclusive lock on `native/`: while
    another holder keeps it, the build waits; once it is released, the build
    finds the finished library."""
    done = []
    fd = os.open(native_t._NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        worker = threading.Thread(target=lambda: done.append(native_t._build()))
        worker.start()
        worker.join(0.5)
        assert not done
    finally:
        os.close(fd)
    worker.join(60)
    assert done == [True]
