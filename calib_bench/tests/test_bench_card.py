"""On the card: one short run of every cell through the command, with the
result line read back.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from calib_bench import harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "calib_bench/run.py", "--workload", cell, "--seed",
         "2147483777", "--seconds", "1", "--trace", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert 0 < result["metrics"]["roofline.window"]["value"] <= 100
