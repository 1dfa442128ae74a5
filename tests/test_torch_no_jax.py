"""The port stands alone: no JAX, no reference package.

An AST scan of every Python file of ``camera_calibration_torch/``, of
``chip_smoke.py`` and of the card tools in ``tools/`` fails on any import of ``jax`` or
``camera_calibration_tpu`` (``import``, ``from ... import``,
``__import__`` and ``importlib.import_module`` with a literal name).  A
fresh interpreter then imports every module of the port and checks that
neither package was loaded, and ``chip_smoke.py`` is checked to refuse to
run, printing no result, without a card and without the repository.
No module of the port imports matplotlib either: the card's machine has
none, so the reports are drawn as rasters.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "camera_calibration_torch"
FORBIDDEN = ("jax", "camera_calibration_tpu")


def _files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "tools").glob("*.py")))


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if (name in ("__import__", "import_module") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


# Modules added by later slices that the scans must see.
NEW_MODULES = ("models/parametric.py", "models/pinhole.py", "ba/gn.py",
               "ba/dataset.py", "io/dataset_bin.py", "native/__init__.py",
               "init/relative_pose.py", "init/p3p.py", "init/dense_init.py",
               "models/fit.py", "init/state_init.py", "calibrate.py",
               "io/state_io.py", "problems.py", "ops/interp.py",
               "ops/dlt.py", "features/tag36h11_data.py",
               "features/pattern.py", "features/apriltag.py",
               "features/degrade.py", "features/refinement.py",
               "features/patch_refinement.py", "features/detector.py",
               "cli.py", "init/noncentral_init.py", "io/meshlab.py",
               "report/__init__.py", "report/raster.py",
               "report/calibration_report.py", "report/fitting_report.py",
               "stereo/__init__.py", "stereo/patch_match.py", "io/colmap.py",
               "io/image_input.py", "ui/__init__.py", "ui/live_capture.py",
               "ui/pattern_display.py", "ui/calibration_visualizer.py",
               "sdk.py", "parallel/__init__.py", "parallel/sharding.py",
               "parallel/distributed.py")


def test_no_forbidden_imports():
    files = _files()
    assert len(files) > 15
    for name in NEW_MODULES:
        assert PORT / name in files, name
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(REPO)}: {name}"
                for name in _imported_names(tree) if _forbidden(name)]
    assert not bad, bad


def test_no_matplotlib_import():
    bad = []
    for path in _files():
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(REPO)}: {name}"
                for name in _imported_names(tree)
                if name.split(".")[0] == "matplotlib"]
    assert not bad, bad


def test_scan_catches_every_import_form():
    src = ("import jax\nimport jax.numpy as jnp\n"
           "from camera_calibration_tpu.ops import se3\n"
           "__import__('jax')\nimportlib.import_module('camera_calibration_tpu')\n"
           "import numpy\nfrom camera_calibration_torch import config\n")
    names = [n for n in _imported_names(ast.parse(src)) if _forbidden(n)]
    assert len(names) == 5


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    for name in NEW_MODULES:
        dotted = name[:-3].replace("/", ".").removesuffix(".__init__")
        assert "camera_calibration_torch." + dotted in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n")
    r = _run(["-c", code], cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout


def _hide_cards():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card_or_repo(tmp_path, alone):
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = REPO
    r = _run(["chip_smoke.py"], cwd=cwd, env=_hide_cards())
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
