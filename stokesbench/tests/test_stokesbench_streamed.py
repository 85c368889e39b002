"""The streamed reference (`reference/streamed.py`) against the dense one
(`reference/loop.py`) on the CPU at the cells' small sizes: on the same
window frame of the program both judge it correct and read the same
geometry and state; the streamed judge fails the program's solution scaled
by 1 + 1e-4 and its control, the solution rounded to float32; and it forms
its residual in row blocks smaller than the operators.

The streamed numbers are held to this test's own limits, between the
program's readings (residual 1.7e-10 to 4.3e-10, balance 1e-14 to 6e-12)
and the float32-rounded solution's (residual 3.8e-8 to 6.8e-8, balance
6.9e-10 to 3.4e-8) at these sizes; no cell judges by them yet, and a cell
that does takes its limits from `calibrate.py`."""

import tempfile

import numpy as np
import pytest

from stokesbench import harness
from stokesbench.reference import loop, streamed

from .twins_contact import SEED, TWINS

LIMITS = {"geometry": 1e-10, "state": 1e-10, "residual": 5e-9, "balance": 1e-10}
#: bytes of Green's functions a row block of the test holds: rows in blocks of 5 to 25 of 98 to 128
BLOCK_BYTES = 2**22


def passes(gaps):
    return all(gaps[n] <= limit for n, limit in LIMITS.items())


@pytest.fixture(scope="module", params=sorted(TWINS))
def frame(request):
    """(the program's loop after three frames, its last frame k, the state
    before k, its outputs of k)."""
    cell = request.param
    geometry, problem = TWINS[cell]
    with tempfile.TemporaryDirectory() as work:
        lp = harness.Loop(harness.Cell.find(cell), SEED, work, "cpu", problem, geometry)
        for _ in range(3):
            lp.step()
        lp.close()
        k = lp.frame - 1
        rot, disp, cand = lp.outputs(k)
        yield cell, lp, k, rot, disp, cand


def test_both_judge_the_program_correct(frame):
    cell, lp, k, rot, disp, cand = frame
    dense = loop.Reference(lp.problem)
    gaps = loop.judge(dense, loop.expected(dense, k, rot, disp), rot, disp, cand)
    limits = harness.Cell.find(cell).limits
    assert all(gaps[n] <= limits[n] for n in limits), gaps
    ref = streamed.Reference(lp.problem, block_bytes=BLOCK_BYTES)
    got = streamed.judge(ref, streamed.expected(ref, k, rot, disp), rot, disp, cand)
    assert set(got) == streamed.numbers(lp.problem)
    assert passes(got), got
    assert got["geometry"] == gaps["geometry"] and got["state"] == gaps["state"]
    # rows in blocks smaller than the operator
    assert ref.blocks > 1 and ref.block_rows < ref.frame.n


def scaled(cand):
    out = dict(cand)
    for key in ("forces", "velocities", "omega"):
        if key in out:
            out[key] = np.asarray(out[key]) * (1 + 1e-4)
    return out


@pytest.mark.parametrize("fault", [scaled, streamed.rounded], ids=["scaled", "float32"])
def test_streamed_fails_a_wrong_solution(frame, fault):
    cell, lp, k, rot, disp, cand = frame
    ref = streamed.Reference(lp.problem, block_bytes=BLOCK_BYTES)
    got = streamed.judge(ref, streamed.expected(ref, k, rot, disp), rot, disp, fault(cand))
    assert not passes(got), got


def test_the_control_is_the_rounded_solution(frame):
    cell, lp, k, rot, disp, cand = frame
    ctl = streamed.Control(lp.problem, "cpu").candidate(k, rot, disp, cand)
    assert np.array_equal(ctl["forces"], cand["forces"].astype(np.float32))
    assert np.array_equal(ctl["velocities"], np.asarray(cand["velocities"]).astype(np.float32))
    assert ctl["euler"] is cand["euler"]
