"""The port's card tools in ``tools/``, on the CPU.

``compare_window_reductions.py`` needs a card: without one it must exit
non-zero and print no result.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TOOLS = REPO / "tools"


def test_compare_tool_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, str(TOOLS / "compare_window_reductions.py"),
         "--other", str(REPO)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"rows"' not in r.stdout
