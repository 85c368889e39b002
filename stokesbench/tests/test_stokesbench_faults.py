"""The harness drives a whole run on the CPU at a small size (its look for a
card skipped) and sees `correct` come out true for the sound program and
false for each fault this kind of cell can have, planted in the timed
path: a frame that returns its state unchanged, and an answer altered
where it is produced.  (A frame loop has no batch to halve and one card no
exchange to leave out.)"""

import numpy as np
import pytest

from stokesbench import harness

from .twins import SEED, TWINS


def run(cell, fault=None):
    geometry, problem = TWINS[cell]
    return harness.run_cell(cell, SEED, 0.0, 0, device="cpu", problem_overrides=problem,
                            geometry_overrides=geometry, fault=fault)


def state_unchanged(loop):
    sim = loop.sim
    inner = sim._advance_state

    def advance(U, N):
        saved = (sim.state.rotation.copy(), sim.state.displacements.copy())
        out = inner(U, N)
        sim.state.rotation, sim.state.displacements = saved
        return out

    sim._advance_state = advance


def velocity_altered(loop):
    prob = loop.sim.problem
    inner = prob.solve_frame

    def solve(*a, **k):
        res = inner(*a, **k)
        res["rigid_velocities"] = np.asarray(res["rigid_velocities"]) * (1 + 1e-4)
        return res

    prob.solve_frame = solve


def traction_altered(loop):
    prob = loop.sim.problem
    inner = prob.solve_frame

    def solve(*a, **k):
        res = inner(*a, **k)
        res["stokes_forces"] = res["stokes_forces"] * (1 + 1e-4)
        return res

    prob.solve_frame = solve


@pytest.mark.parametrize("cell", ["sphere_wall-loop", "bacterium-loop"])
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, velocity_altered, traction_altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["sphere_wall-loop", "bacterium-loop"])
def test_fault_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out["correct"], out["checks"]
