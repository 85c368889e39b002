"""The `sphere_wall-contact` cell on the CPU at its small size: the harness
sees `correct` come out true for the sound program and false for each
fault planted in the timed path; the program stays inside every limit of
the cell and the float32 control fails one; and the reader of the near-pair
delta (`near_delta_ms`) on a registry filled by hand."""

import pytest

import bemstokes_tpu_torch.utils as program_utils
from stokesbench import calibrate, harness
from stokesbench.metrics import near_delta_ms

from .test_stokesbench_faults import state_unchanged, traction_altered, velocity_altered
from .test_stokesbench_program_spans import add, record, registry  # noqa: F401  (a fixture)
from .twins_contact import CONTACT, SEED, TWINS


def run(fault=None):
    geometry, problem = TWINS[CONTACT]
    return harness.run_cell(CONTACT, SEED, 0.0, 0, device="cpu", problem_overrides=problem,
                            geometry_overrides=geometry, fault=fault)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [state_unchanged, velocity_altered, traction_altered], ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    out = run(fault)
    assert not out["correct"], out["checks"]


def test_program_and_control_against_the_reference():
    geometry, problem = TWINS[CONTACT]
    row = calibrate.readings(CONTACT, SEED, 0.0, control=True, device="cpu",
                             problem_overrides=problem, geometry_overrides=geometry)
    limits = harness.Cell.find(CONTACT).limits
    assert row["checked"], row
    for n, g in row["program"].items():
        assert g <= limits[n], (n, g, limits[n])
    assert any(row["control"][n] > limits[n] for n in limits), row["control"]
    # the control reads apart from the program in every number it compares
    for n in limits:
        assert row["control"][n] >= 3 * row["program"][n], (n, row)


def test_near_delta_a_frame(registry):  # noqa: F811
    """The outermost "Near delta" spans of the window's frames, their
    children not counted twice; none in a frame of an earlier run."""
    for k, t0, near in ((7, 0, 90.0), (3, 1000, 40.0), (4, 2000, 60.0)):
        f = add(registry, "Frame", None, t0, t0 + 200, frame=k)
        asm = add(registry, "Assemble", f, t0 + 10, t0 + 150)
        d = add(registry, "Near delta", asm, t0 + 20, t0 + 20 + near, rows=6146, near_panels=32)
        add(registry, "Near selection", d, t0 + 21, t0 + 25)
        add(registry, "Near local blocks", d, t0 + 25, t0 + 15 + near)
    # a frame of the window without promotion holds none
    add(registry, "Frame", None, 3000, 3100, frame=5)
    assert near_delta_ms.read(record(3)) == pytest.approx((40 + 60) / 3)
    assert near_delta_ms.read(record(1)) is None


def test_near_delta_reads_nothing_without_spans(registry, monkeypatch):  # noqa: F811
    assert near_delta_ms.read(record(3)) is None
    f = add(registry, "Frame", None, 0, 10, frame=0)
    add(registry, "Near delta", f, 1, 3)
    assert near_delta_ms.read(record(2)) is None  # fewer frames than the window

    class Plain:  # a registry that keeps timers only
        pass

    monkeypatch.setattr(program_utils, "timers", Plain())
    assert near_delta_ms.read(record(1)) is None
