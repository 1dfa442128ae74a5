"""Port parity: ``calibrate --state_directory … --model
central_thin_prism_fisheye``, the command line's resume into another
model kind (``resample_models_if_necessary`` fits the parametric model to
the saved grid, then the BA runs), on the dataset and saved state of
``tests/test_torch_cli.py``, float64, the port on the CPU.

Tolerance: the same LM counts and outliers, the saved states within 1e-3
relative (observed 2.5e-4) and the final costs within 1e-2: a 6×6 grid
determines the fit's distortion terms poorly, so the reference's own fit
moves by ~1e-5 relative under ±1e-14 changes of its input.

The module runs with one intra-op thread (see ``_one_torch_thread``).
"""

from camera_calibration_torch.io import state_io as tstate_io
from test_torch_cli import (  # noqa: F401  (module fixtures)
    _assert_same_run, _one_torch_thread, _resume_runs, _state_gap, setup)


def test_calibrate_resume_to_another_model(setup, tmp_path):
    ref, port, ref_rep, port_rep = _resume_runs(
        setup, tmp_path, ["--model", "central_thin_prism_fisheye"])
    state, _, _ = tstate_io.load_ba_state(port, device="cpu")
    assert type(state.intrinsics[0]).__name__ == "CentralThinPrismFisheyeModel"
    assert _state_gap(ref, port) <= 1e-3
    _assert_same_run(ref_rep, port_rep, 1e-2)
