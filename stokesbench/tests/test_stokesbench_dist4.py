"""The cell `sphere_fine-dist4` on the CPU at a small size: its twin
(`dist_fine.py`, create_sphere(2) over two gloo ranks under
`loop_direct_dist`, judged by the streamed reference against the cell's
limits) reads `correct` true, traced, with every per-layer metric the cell
reports; with the exchange between the ranks left out of rank 0's sharded
matvec it reads `correct` false.  And the readers of the distributed step
(`slab_assembly_ms`, `dist_gmres_iter_ms`, `collectives_per_iter`) on a
registry filled by hand: the window's spans of the distributed solves
only, and nothing where there are none."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import bemstokes_tpu_torch.utils as program_utils
from stokesbench import harness
from stokesbench.metrics import collectives_per_iter, dist_gmres_iter_ms, slab_assembly_ms

from .dist_fine import CELL
from .test_stokesbench_program_spans import add, record, registry  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parent.parent.parent
READERS = (slab_assembly_ms, dist_gmres_iter_ms, collectives_per_iter)


def twin(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "stokesbench.tests.dist_fine", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_twin_is_correct_and_reads_every_metric():
    result = twin("--trace", "1")
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"geometry", "state", "residual", "balance"}
    assert result["device"]["count"] == 2
    reported = {m["name"] for m in harness.Cell.find(CELL).per_layer}
    # the rooflines read the card's trace, which a CPU run has not
    assert set(result["metrics"]) == reported - {"bulk_roofline", "matvec_roofline"}
    # at least the 2W + 3 collectives of each iteration (W = 2)
    assert result["metrics"]["collectives_per_iter"]["value"] >= 7


def test_exchange_left_out_is_not_correct():
    result = twin("--fault", "exchange")
    assert not result["correct"], result["checks"]
    assert result["checks"]["residual"]["value"] > result["checks"]["residual"]["limit"]


def solve(reg, frame, t0, iterations, collectives, sharded=True):
    """A 20 ms GMRES at t0 ms under an "Assemble + LAC Solve" of `frame`,
    its `collectives` counted on an iteration's "Slab LU apply" and its
    matvecs "Sharded matvec" spans (plain "Matvec" spans without
    `sharded`)."""
    top = add(reg, "Assemble + LAC Solve", frame, t0, t0 + 30)
    if sharded:
        add(reg, "Slab assembly", top, t0, t0 + 8, world=4, m=18435)
    g = add(reg, "GMRES", top, t0 + 10, t0 + 30, iterations=iterations, counts={"collectives": 4})
    pre = add(reg, "Preconditioner", g, t0 + 11, t0 + 15)
    if sharded:
        add(reg, "Slab LU apply", pre, t0 + 11, t0 + 14, world=4, m=18435, steps=8,
            counts={"collectives": collectives - 4})
    mv = add(reg, "Matvec", g, t0 + 15, t0 + 17)
    add(reg, "Sharded matvec" if sharded else "Node sweep", mv, t0 + 15, t0 + 16, world=4, m=18435)


def test_readers_read_the_distributed_solves(registry):  # noqa: F811
    # a frame of an earlier run, then the window's two frames
    for k, t0, its, coll in ((7, 0, 9, 200), (3, 1000, 4, 59), (4, 2000, 6, 81)):
        f = add(registry, "Frame", None, t0, t0 + 100, frame=k)
        solve(registry, f, t0, its, coll)
    # a one-card solve in the window is not the distributed step's
    solve(registry, f, 2040, 5, 0, sharded=False)
    rec = record(2)
    assert slab_assembly_ms.read(rec) == pytest.approx(8.0)
    assert dist_gmres_iter_ms.read(rec) == pytest.approx(40 / 10)
    assert collectives_per_iter.read(rec) == pytest.approx((59 + 81) / 10)


def test_nested_slab_assembly_counts_once(registry):  # noqa: F811
    f = add(registry, "Frame", None, 0, 100, frame=0)
    outer = add(registry, "Slab assembly", f, 10, 30)
    add(registry, "Slab assembly", outer, 12, 20)
    assert slab_assembly_ms.read(record(1)) == pytest.approx(20.0)


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[1])
def test_one_card_solves_read_nothing(registry, reader):  # noqa: F811
    f = add(registry, "Frame", None, 0, 100, frame=0)
    solve(registry, f, 0, 5, 0, sharded=False)
    assert reader.read(record(1)) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[1])
def test_empty_registry_reads_nothing(registry, reader):  # noqa: F811
    assert reader.read(record(3)) is None
    f = add(registry, "Frame", None, 0, 100, frame=0)
    solve(registry, f, 0, 5, 59)
    assert reader.read(record(2)) is None  # fewer frames than the window


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[1])
def test_registry_without_spans_reads_nothing(monkeypatch, reader):
    class Plain:  # a registry that keeps timers only
        pass

    monkeypatch.setattr(program_utils, "timers", Plain())
    assert reader.read(record(1)) is None
