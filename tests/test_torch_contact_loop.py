"""The sphere towed 0.02 radii from the Blake no-slip wall on the port's frame
loop, on the CPU: the small twin of the benchmark's `sphere_wall-contact`
cell (create_sphere(2) at a centre height of 1.02 radii, far rule order 2,
near pairs order 8).  Two frames of `SwimmerSimulation.run` carry their
stale LU and rigid state as the benchmark's loop does; the second is judged
against the benchmark's plain float64 reference (`stokesbench/reference`,
which imports nothing of the program) under the cell's own limits.  The
quadrature auto-promotion fires in the twin and not in the twin of the
unpromoted `sphere_wall-loop` cell."""

import pytest

from stokesbench import harness
from stokesbench.tests.twins_contact import CONTACT, SEED, TWINS
import torch_threads  # noqa: F401  (one torch thread a test process)


def loop_of(cell, tmp_path):
    geometry, problem = TWINS[cell]
    return harness.Loop(harness.Cell.find(cell), SEED, tmp_path / cell, "cpu", problem, geometry)


@pytest.mark.parametrize("cell, promoted", [(CONTACT, True), ("sphere_wall-loop", False)])
def test_twin_promotes_only_near_contact(cell, promoted, tmp_path):
    loop = loop_of(cell, tmp_path)
    prob = loop.sim.problem
    decision = prob.quadrature_promotion
    assert prob.quadrature_promoted is promoted and decision["promoted"] is promoted
    assert (decision["gap"] < decision["diameter"]) is promoted
    height = loop.problem["walls"][0]["position"][1]
    # the lowest vertex lies on the unit sphere; the gap is to its image
    assert decision["gap"] == pytest.approx(2 * (-height - 1.0), rel=1e-4)
    assert (decision["order_far"], decision["order_near"]) == ((2, 8) if promoted else (4, 4))
    loop.close()


def scale_tractions(loop):
    prob = loop.sim.problem
    inner = prob.solve_frame

    def solve(*a, **k):
        res = inner(*a, **k)
        res["stokes_forces"] = res["stokes_forces"] * (1 + 1e-4)
        return res

    prob.solve_frame = solve


@pytest.mark.parametrize("fault", [None, scale_tractions], ids=["sound", "tractions_scaled"])
def test_contact_loop_against_the_reference(fault, tmp_path):
    cell = harness.Cell.find(CONTACT)
    loop = loop_of(CONTACT, tmp_path)
    if fault is not None:
        fault(loop)
    frames = [loop.step(), loop.step()]
    loop.close()
    assert [h["frame"] for h in loop.history] == frames == [0, 1]
    assert all(h["iterations"] < loop.problem["solver"]["max_steps"] for h in loop.history)
    gaps, _ = harness.check(loop, cell, [1], "cpu")
    assert set(gaps) == set(cell.limits)
    if fault is None:
        for name, limit in cell.limits.items():
            assert gaps[name] <= limit, (name, gaps)
    else:
        assert gaps["traction"] > cell.limits["traction"], gaps
        for name in ("geometry", "state", "velocity"):
            assert gaps[name] <= cell.limits[name], (name, gaps)
