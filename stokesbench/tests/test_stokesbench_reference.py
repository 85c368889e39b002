"""The plain reference against the program on the CPU at small sizes, and
the control (the reference in float32) against the reference: the program
stays inside every limit of its cell, the control fails at least one."""

import pytest

from stokesbench import calibrate, harness

from .twins import SEED, TWINS


@pytest.mark.parametrize("cell", sorted(TWINS))
def test_program_and_control_against_the_reference(cell):
    geometry, problem = TWINS[cell]
    row = calibrate.readings(cell, SEED, 0.0, control=True, device="cpu",
                             problem_overrides=problem, geometry_overrides=geometry)
    limits = harness.Cell.find(cell).limits
    assert row["checked"], row
    for n, g in row["program"].items():
        assert g <= limits[n], (n, g, limits[n])
    assert any(row["control"][n] > limits[n] for n in limits), row["control"]
    # the control reads apart from the program in every number it compares
    for n in limits:
        assert row["control"][n] >= 3 * row["program"][n], (n, row)


def test_reference_reads_the_frame_files_as_the_program_does(tmp_path):
    from bemstokes_tpu_torch.mesh.io import read_msh as program_read

    from stokesbench import gen
    from stokesbench.reference import bem

    gen.write_bacterium_gait(str(tmp_path), "b_", dict(head_center=[-1.0, 0, 0], head_radius=0.8, head_refinements=1,
                                                      tube=[16, 6], frames_per_turn=2, jitter=1e-6), SEED)
    verts, cells = bem.read_msh(str(tmp_path / "b_1.msh"))
    mesh = program_read(str(tmp_path / "b_1.msh"))
    assert (cells == mesh.cells).all() and (verts == mesh.vertices).all()
