"""A tiny deployment of each configuration kind, for runs on the CPU.

The benchmark's tests run from the repository's root with ``python -m
pytest calib_bench/tests -p no:cacheprovider``; the ``gpu`` tests skip
without a card."""

import json
from pathlib import Path

from calib_bench import harness

DATA = Path(__file__).resolve().parent / "data"
CONFIGS = {"cg1080.ba_final": DATA / "tiny-cg.json",
           "ncg1080.ba_final": DATA / "tiny-ncg.json"}


def config(cell):
    return json.loads(CONFIGS[cell].read_text())


def run(cell, seed=2147483659, seconds=0.01, trace=False):
    """One run of ``cell`` on the CPU at the tiny size: (result, lines)."""
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            config_path=CONFIGS[cell])
