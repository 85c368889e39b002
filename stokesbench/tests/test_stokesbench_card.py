"""The command line: without a card it prints no result and fails; on the
card (marked `cuda`) one short run of a cell prints a correct result line
with the cell's end-to-end metrics."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent


def cli(*args, timeout):
    return subprocess.run(
        [sys.executable, "stokesbench/run.py", *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout
    )


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = cli("--workload", "sphere_wall-loop", "--seed", "1", "--seconds", "1", "--trace", "0", timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = cli("--workload", "sphere_wall-loop", "--seed", "7", "--seconds", "2", "--trace", "0", timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and {"setup_s", "frame_s", "frame_p95_s", "peak_mem_gib"} <= set(result["metrics"])
