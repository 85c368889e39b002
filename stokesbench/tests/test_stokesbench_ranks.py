"""A cell over several cards, on the CPU: `sphere_wall-loop`'s small twin
run by rank 0 and a second rank in a gloo group (`dist_cell.py`) prints one
result line, with `device.count` 2 and the same window frames on both
ranks; a rank that exits at its second frame ends the run with 1 and no
result line well within the collective timeout; a rank that hangs at its
second frame, without exiting, ends it with 1 and no result line once the
collective timeout has passed; a rank that holds a module of JAX once its
window has closed ends it with 1 and no result line; a cell on several
cards whose mix does not set `distributed` is refused before any rank
starts."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from stokesbench import harness, ranks

from .dist_cell import CELL, bench
from .twins import SEED, TWINS

ROOT = Path(__file__).resolve().parent.parent.parent


def rank0(*args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "stokesbench.tests.dist_cell", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out, time.monotonic() - t0


def result_lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith("{")]


def test_two_ranks_print_one_result():
    out, _ = rank0()
    assert out.returncode == 0, out.stderr[-3000:]
    lines = result_lines(out.stdout)
    assert len(lines) == 1 and out.stdout.strip().splitlines()[-1] == lines[0]
    result = json.loads(lines[0])
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 2
    per_rank = result["timings"]["ranks"]
    assert [r["rank"] for r in per_rank] == [0, 1]
    assert per_rank[0]["frames"] == per_rank[1]["frames"] and len(per_rank[0]["frames"]) == result["attempted"] >= 1
    assert result["device"]["memory_peak_bytes"] == max(r["peak_bytes"] for r in per_rank)


def test_a_rank_that_dies_ends_the_run():
    out, seconds = rank0("--fault", "exit")
    assert out.returncode == 1, (out.returncode, out.stderr[-3000:])
    assert result_lines(out.stdout) == []
    assert "rank 1 exited with 3" in out.stderr and "last" in out.stderr
    assert seconds < ranks.COLLECTIVE_TIMEOUT_S


def test_a_rank_that_hangs_ends_the_run_at_the_collective_timeout():
    out, seconds = rank0("--fault", "hang", timeout=ranks.COLLECTIVE_TIMEOUT_S + 240)
    assert out.returncode == 1, (out.returncode, out.stderr[-3000:])
    assert result_lines(out.stdout) == []
    assert "rank 0 failed (rank 1 running)" in out.stderr, out.stderr[-3000:]
    # the group's collectives, not the harness's join, ended the run: rank 0
    # waited the whole timeout, and not much longer
    assert ranks.COLLECTIVE_TIMEOUT_S <= seconds < ranks.COLLECTIVE_TIMEOUT_S + 60, seconds


def test_a_rank_that_loads_jax_prints_no_result():
    out, _ = rank0("--fault", "jax")
    assert out.returncode == 1, (out.returncode, out.stderr[-3000:])
    assert result_lines(out.stdout) == []
    assert "modules of JAX or the JAX package were loaded on rank(s) {1: ['jax']}" in out.stderr, out.stderr[-3000:]


def test_several_cards_need_a_distributed_mix(tmp_path, monkeypatch):
    b = bench(2)
    for w in b["workloads"]:
        if w["name"] == CELL:
            w["traffic"] = "loop_direct"
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    geometry, problem = TWINS[CELL]
    with pytest.raises(SystemExit, match="distributed"):
        harness.run_cell(CELL, SEED, 0.0, 0, device="cpu", problem_overrides=problem, geometry_overrides=geometry,
                         bench=b)
    assert list(tmp_path.iterdir()) == []
