"""Port parity: the initial BA state of a NoncentralGeneric camera,
``build_ba_state(model_kind="noncentral_generic")``, from the same
``NoncentralInitResult`` in both packages (the reference's initialization
of the dataset of ``tests/test_torch_noncentral_init.py``), at a 5×5 grid
in float64 on the CPU.

Held: the poses and points to 1e-8 relative and the observation tables
identical.  The grids come from capped-CG LM fits (the direction grid as a
central fit, the origin grid to the line anchors) that the reference's own
run moves by ~1e-4 under a 1e-14 relative change of its input, so, as in
``tests/test_torch_init.py``, both grids are held to twice that change,
measured here and asserted above 1e-9 (observed at this input: directions
2.4e-5 against 6.7e-5, origins 9.8e-5 against 4.6e-4).

The module runs with one intra-op thread (see ``_one_torch_thread``).
"""

import dataclasses
import functools

import numpy as np
import pytest

from camera_calibration_torch.init import state_init as tsi
from camera_calibration_torch.models.noncentral_generic import (
    NoncentralGenericModel)
from camera_calibration_tpu.init import noncentral_init as jni
from camera_calibration_tpu.init import state_init as jsi
from test_torch_noncentral_init import (  # noqa: F401  (module fixtures)
    OPTIONS, POLISH_POINTS, _one_torch_thread, _port_result, _rel, datasets)

GRID = (5, 5)


@pytest.fixture(scope="module")
def result(datasets):
    """The reference's initialization (bootstrap polish on POLISH_POINTS
    pixels, as in the init parity file)."""
    cls = jni.NoncentralDenseInitializer
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "_polish_bootstrap", functools.partialmethod(
            cls._polish_bootstrap, max_points=POLISH_POINTS))
        res = cls(datasets[1], 0, jni.di.DenseInitOptions(**OPTIONS)).run()
    assert res is not None
    return res


def test_build_ba_state_noncentral(datasets, result):
    ds_t, ds_j = datasets
    sj, dj, fj, uj = jsi.build_ba_state(
        ds_j, [result], GRID, model_kind="noncentral_generic")
    st, dt, ft, ut = tsi.build_ba_state(
        ds_t, [_port_result(result)], GRID, model_kind="noncentral_generic",
        device="cpu")
    nudged = dataclasses.replace(result,
                                 point_sum=result.point_sum * (1 + 1e-14))
    mn = jsi.fit_initial_model_noncentral(nudged, GRID)
    assert fj == ft and uj == ut
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        assert _rel(np.asarray(getattr(sj, name)),
                    getattr(st, name).numpy()) <= 1e-8, name
    mj, mt = sj.intrinsics[0], st.intrinsics[0]
    assert isinstance(mt, NoncentralGenericModel)
    for name in ("direction_grid", "point_grid"):
        ref = np.asarray(getattr(mj, name))
        spread = np.abs(np.asarray(getattr(mn, name)) - ref).max()
        assert spread > 1e-9, name
        assert np.abs(getattr(mt, name).numpy() - ref).max() <= 2 * spread, \
            name
    for tj, tt in zip(dj, dt):
        for name in ("imageset", "camera", "point", "pixel", "valid"):
            assert np.array_equal(np.asarray(getattr(tj, name)),
                                  getattr(tt, name).numpy()), name

