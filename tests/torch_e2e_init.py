"""The feature dataset of ``tests/test_e2e.py`` and its dense
initialization by the reference package and by the port, each computed
once per process and shared by ``tests/test_torch_init.py`` and
``tests/test_torch_calibrate.py``.  Callers must not modify what they get.
"""

import functools

from camera_calibration_torch import problems
from camera_calibration_torch.init import dense_init as tdi
from camera_calibration_tpu.init import dense_init as jdi
import test_dense_init as ref_tdi

# tests/test_e2e.py's dataset and initialization options
DATASET = dict(seed=2, n_imagesets=10, k=12, w=320, h=240)
INIT = dict(max_initialization_attempts=100, seed=3,
            min_matched_area_accept=0.15)


@functools.cache
def reference():
    """(dataset, DenseInitResult) of the reference package."""
    ds = ref_tdi._make_synthetic_dataset(**DATASET)[0]
    return ds, jdi.DenseInitializer(ds, 0, jdi.DenseInitOptions(**INIT)).run()


@functools.cache
def port():
    """(dataset, DenseInitResult) of the port, on the CPU."""
    ds = problems.make_calibration_dataset(**DATASET)[0]
    return ds, tdi.DenseInitializer(ds, 0, tdi.DenseInitOptions(**INIT)).run()
