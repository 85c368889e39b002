"""The instruction counting of scripts/torch_sass_count.py, on a made-up
disassembly in the format `cuobjdump -sass` prints (the card's toolkit is
not needed): the sample loop is the smallest region closed by a backward
branch that holds an inverse square root, one trip follows the loop's
common arm, the image node sweeps take two inverse square roots a sample,
`node_row` finds the instantiation a node sweep's timing is served by, and
`pipe_floors` turns a count into the least time at a clock.
"""

import importlib.util
from pathlib import Path

import pytest
import torch_threads  # noqa: F401  (one torch thread a test process)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def sc():
    spec = importlib.util.spec_from_file_location("torch_sass_count", ROOT / "scripts" / "torch_sass_count.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _function(name, body):
    lines = [f"        Function : {name}"]
    for k, text in enumerate(body):
        lines.append(f"        /*{16 * k:04x}*/                   {text} ;   /* 0x0000000000000000 */")
    return "\n".join(lines)


def _loop(rsq, fp64, rare_arm=0):
    """A function whose loop at 0x20 holds `rsq` MUFU.RSQ64H and `fp64` DFMA
    on its common arm; with `rare_arm`, the common arm is reached through a
    conditional forward branch that falls through and leaves by an
    unconditional one over `rare_arm` DMUL."""
    body = ["MOV R1, c[0x0][0x28]", "LDS R2, [R3]"]
    common = ["MUFU.RSQ64H R4, R5"] * rsq + ["DFMA R6, R6, R8, R10"] * fp64
    if rare_arm:
        rare = 16 * (len(body) + 1 + len(common) + 1)
        end = rare + 16 * rare_arm
        body += [f"@P0 BRA 0x{rare:x}"] + common + [f"BRA 0x{end:x}"] + ["DMUL R6, R6, R8"] * rare_arm
    else:
        body += common
    body += ["IADD3 R1, R1, 0x1, RZ", "@!P1 BRA 0x20", "EXIT"]
    return body


K3 = "_ZN12_GLOBAL__N_118image_sweep_kernelIdLi2ELi1EEEvPKT_S3_S3_S3_PS1_S4_lllS1_"
K3_X = "_ZN12_GLOBAL__N_118image_sweep_kernelIdLi2ELi0EEEvPKT_S3_S3_S3_PS1_S4_lllS1_"
K1 = "_ZN12_GLOBAL__N_117node_sweep_kernelIdLb0EEEvPKT_S3_S3_S3_PS1_S4_lll"
K4 = "_ZN12_GLOBAL__N_117node_sweep_kernelIdLb1EEEvPKT_S3_S3_S3_PS1_S4_lll"


def test_template_arguments(sc):
    assert sc.template_ints(K3) == ("d", [2, 1])
    assert sc.template_ints(K4) == ("d", [1])


def test_counts_per_interaction(sc):
    sass = "\n".join(
        [_function(K1, _loop(rsq=8, fp64=320)), _function(K3, _loop(rsq=8, fp64=416, rare_arm=5))]
    )
    rows = {r["mangled"]: r for r in sc.count_loops(sass, None)}
    # K1: one inverse square root an interaction, 8 interactions a trip
    assert rows[K1]["samples_in_loop"] == 8 and rows[K1]["per_sample"]["fp64"] == 40
    # K3: two a sample (the point and its mirror); the unconditional branch
    # over the rare arm is followed, so its DMULs are not counted
    assert rows[K3]["samples_in_loop"] == 4 and rows[K3]["per_sample"]["fp64"] == 104
    assert rows[K3]["per_sample"]["mufu"] == 2


def test_node_row_serves_each_timed_sweep(sc):
    sass = "\n".join(
        _function(name, _loop(rsq=2, fp64=2 * k + 2)) for k, name in enumerate((K1, K4, K3_X, K3))
    )
    rows = sc.count_loops(sass, None)
    assert sc.node_row(rows, "float64", sc.NODE_SWEEPS["K1"][3])["mangled"] == K1
    assert sc.node_row(rows, "float64", sc.NODE_SWEEPS["K4"][3])["mangled"] == K4
    # the timed image sweeps have their wall along y
    assert sc.node_row(rows, "float64", sc.NODE_SWEEPS["K3"][3])["mangled"] == K3
    assert sc.node_row(rows, "float32", sc.NODE_SWEEPS["K3"][3]) is None


def test_pipe_floor(sc):
    row = dict(template_ints=[0], loop_instructions=100, samples_in_loop=2, per_sample={"fp64": 40.0})
    out = sc.pipe_floors(row, "float64", 6146 * 6146 * 64, {"sm_clock_mhz": 1980.0}, 132)
    # 40 instructions x 2.4175e9 interactions / (132 SMs x 64 lanes x 1.98 GHz)
    assert out["pipe_floor_ms"] == pytest.approx(5.781, abs=1e-3)
    assert out["issue_floor_ms"] == pytest.approx(50 / 40 * 5.781 / 2, abs=1e-3)
