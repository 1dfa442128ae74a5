"""The check that decides ``correct``: each mix at a tiny size, the control
and the program's faults (each must read not correct), and the import
guard."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from calib_bench import harness
from calib_bench.tests import tiny

CELLS = list(tiny.CONFIGS)


@pytest.mark.parametrize("cell", CELLS)
def test_mix_is_correct_at_a_tiny_size(cell):
    result, lines = tiny.run(cell)
    assert result["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The control's readings, through the unit's own solves and check,
    fail a limit, and the program's pass them."""
    from calib_bench import control

    lim = json.loads((harness.BENCH / "limits" / f"{cell}.json").read_text())
    rows = control.readings(cell, [7], 1, device="cpu",
                            config_path=tiny.CONFIGS[cell])
    ctl = [r["numbers"] for r in rows if r["variant"] == "control"][0]
    assert set(ctl) == set(lim)
    assert any(ctl[k] > lim[k] for k in lim), ctl
    prog = [r["numbers"] for r in rows if r["variant"] == "program"][0]
    assert all(prog[k] <= lim[k] for k in lim), prog


def test_reference_pixel_jacobian_is_the_projections_derivative():
    """The reference's implicit derivative of the pixel by the point, which
    the step gain reads, against central differences of its projection."""
    from calib_bench import synth
    from calib_bench.reference import camera as ref

    for cell in CELLS:
        truth, pixel, kept = synth.make_problem(tiny.config(cell), "cpu")
        rows = torch.nonzero(kept)[:40, 0]
        x = ref.camera_points(truth, rows, truth["points"].shape[0])
        px, ok, jac = ref.project(truth, x, pixel[rows], jacobian=True)
        assert bool(ok.all())
        h = 1e-6
        for i in range(3):
            e = torch.zeros(3, dtype=torch.float64)
            e[i] = h
            fd = (ref.project(truth, x + e, px)[0]
                  - ref.project(truth, x - e, px)[0]) / (2 * h)
            torch.testing.assert_close(jac[:, :, i], fd, rtol=1e-6,
                                       atol=1e-6 * float(jac.abs().max()))


def _unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    from camera_calibration_torch.ba import lm_pcg

    monkeypatch.setattr(lm_pcg, "retract",
                        lambda state, tangent, scale=1.0: state)


def _half_batch(monkeypatch):
    """Half of the batch left out, the cost taken as the mean over the rest
    (scaled to the whole)."""
    from camera_calibration_torch import calibrate

    real = calibrate.run_ba

    def half(state, data, *args, **kw):
        seg = data[0]
        keep = torch.arange(seg.valid.shape[0]) < seg.valid.shape[0] // 2
        st, info = real(state, (dataclasses.replace(
            seg, valid=seg.valid & keep.to(seg.valid.device)),), *args, **kw)
        info["final_cost"] = 2.0 * info["final_cost"]
        return st, info

    monkeypatch.setattr(calibrate, "run_ba", half)


def _altered(monkeypatch):
    """The answer altered where it is produced: every point of the solved
    state moved by 1 mm."""
    from camera_calibration_torch import calibrate

    real = calibrate.run_ba

    def altered(*args, **kw):
        st, info = real(*args, **kw)
        return dataclasses.replace(st, points=st.points + 1e-3), info

    monkeypatch.setattr(calibrate, "run_ba", altered)


def _stopped_early(monkeypatch):
    """A solve that ends early: two LM iterations of the budget."""
    from camera_calibration_torch import calibrate

    real = calibrate.run_ba

    def stopped(state, data, max_iterations, *args, **kw):
        return real(state, data, min(max_iterations, 2), *args, **kw)

    monkeypatch.setattr(calibrate, "run_ba", stopped)


def _control(monkeypatch):
    """The control in the program's place: the reference in TF32."""
    from calib_bench.units import ba_solve

    real = ba_solve.setup

    def setup(*args, **kw):
        job = real(*args, **kw)
        job.use_control()
        return job

    monkeypatch.setattr(ba_solve, "setup", setup)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered,
                                   _stopped_early, _control],
                         ids=["state_unchanged", "half_batch", "altered",
                              "stopped_early", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    """The whole run but the look for a card, with the timed path broken
    underneath: ``correct`` comes out false."""
    fault(monkeypatch)
    result, lines = tiny.run(cell)
    assert result["correct"] is False, lines


def _modules_after(code, cwd):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_imports_no_jax():
    """Every module a run imports, compared by its whole top-level name."""
    code = ("from calib_bench.tests import tiny\n"
            "tiny.run('cg1080.ba_final', trace=True)\n"
            "tiny.run('ncg1080.ba_final')\n"
            "import calib_bench.control")
    found = _modules_after(code, harness.ROOT)
    assert not found & set(harness.FORBIDDEN), found & set(harness.FORBIDDEN)
    assert "camera_calibration_torch" in found


def test_reference_imports_nothing_of_the_program():
    found = _modules_after("import calib_bench.reference.camera",
                           harness.ROOT)
    assert not found & ({"camera_calibration_torch"} | set(harness.FORBIDDEN))
    for path in (harness.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        for word in ("import camera_calibration", "from camera_calibration",
                     "import jax", "from jax"):
            assert word not in text, (path, word)


def test_no_file_of_the_benchmark_reads_the_jax_package_or_its_records():
    words = ("import jax", "from jax", "import camera_calibration_tpu",
             "from camera_calibration_tpu", "bench.py", "benchmarks/",
             "BENCH_r", "MULTICHIP_")
    for path in harness.BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in words:
            assert word not in text, (path, word)
