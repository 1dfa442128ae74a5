"""Port parity: the NumPy consumer SDK (``camera_calibration_torch/sdk.py``).

The port's SDK loads the intrinsics YAML that the port's ``state_io``
writes, for the CentralGeneric model of ``tests/ba_harness.py`` and a
NoncentralGeneric model on its grid (origins drawn from a seed), float64:

- ``unproject`` within 1e-9 of the reference package's SDK on the same
  file, of the reference's ``central_generic.unproject`` and of the port's
  own model (``models/central_generic.unproject`` on the CPU);
- the Jacobian of ``unproject_with_jacobian`` within 1e-5 of central
  differences, and ``project`` ∘ ``unproject`` back to the pixels within
  1e-4 (``tests/test_sdk.py``'s bars);
- the NoncentralGeneric loader's directions and origins within 1e-9 of the
  reference SDK's and of the port model's ``unproject``.

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_harness
from camera_calibration_torch import convert
from camera_calibration_torch import sdk as tsdk
from camera_calibration_torch.io import state_io
from camera_calibration_torch.models import central_generic as tcg
from camera_calibration_torch.models import noncentral_generic as tncg
from camera_calibration_tpu import sdk as jsdk
from camera_calibration_tpu.models import central_generic as jcg
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def central(tmp_path_factory):
    """(reference model, port model, its YAML path, pixels)."""
    _, jmodel = ba_harness.make_gt_model()
    tmodel = convert.camera_model(jmodel, device="cpu")
    path = tmp_path_factory.mktemp("sdk") / "intrinsics0.yaml"
    state_io.save_camera_model(tmodel, path)
    px = np.random.default_rng(0).uniform(
        [2, 2], [jmodel.width - 2, jmodel.height - 2], (200, 2))
    return jmodel, tmodel, path, px


def test_central_loader_matches(central):
    jmodel, tmodel, path, px = central
    cam = tsdk.load_camera(path)
    assert isinstance(cam, tsdk.CentralGenericCamera)
    d = cam.unproject(px)
    np.testing.assert_allclose(d, jsdk.load_camera(path).unproject(px),
                               rtol=0, atol=1e-9)
    d_jax, _ = jcg.unproject(jmodel, jnp.asarray(px))
    np.testing.assert_allclose(d, np.asarray(d_jax), rtol=0, atol=1e-9)
    d_port, _ = tcg.unproject(tmodel, torch.as_tensor(px))
    np.testing.assert_allclose(d, d_port.numpy(), rtol=0, atol=1e-9)
    assert cam.in_calibrated_area(px).all()
    np.testing.assert_allclose(cam.grid_to_pixel(cam.pixel_to_grid(px)), px,
                               rtol=0, atol=1e-9)


def test_jacobian_and_round_trip(central):
    _, _, path, px = central
    cam = tsdk.load_camera(path)
    _, jac = cam.unproject_with_jacobian(px[:5])
    eps = 1e-6
    for k in range(2):
        dp, dm = px[:5].copy(), px[:5].copy()
        dp[:, k] += eps
        dm[:, k] -= eps
        fd = (cam.unproject(dp) - cam.unproject(dm)) / (2 * eps)
        np.testing.assert_allclose(jac[:, :, k], fd, rtol=0, atol=1e-5)
    pts = cam.unproject(px) * np.random.default_rng(1).uniform(
        0.5, 3.0, (200, 1))
    reproj, valid = cam.project(pts)
    assert valid.all()
    np.testing.assert_allclose(reproj, px, rtol=0, atol=1e-4)


def test_noncentral_loader_matches(central, tmp_path):
    _, tmodel, _, px = central
    origins = 0.01 * np.random.default_rng(2).normal(0, 1, tmodel.grid.shape)
    model = tncg.NoncentralGenericModel(
        direction_grid=tmodel.grid,
        point_grid=torch.as_tensor(origins),
        width=tmodel.width, height=tmodel.height,
        calibration_min_x=tmodel.calibration_min_x,
        calibration_min_y=tmodel.calibration_min_y,
        calibration_max_x=tmodel.calibration_max_x,
        calibration_max_y=tmodel.calibration_max_y)
    path = tmp_path / "intrinsics0.yaml"
    state_io.save_camera_model(model, path)
    cam = tsdk.load_camera(path)
    assert isinstance(cam, tsdk.NoncentralGenericCamera)
    d, o = cam.unproject(px)
    d_ref, o_ref = jsdk.load_camera(path).unproject(px)
    np.testing.assert_allclose(d, d_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(o, o_ref, rtol=0, atol=1e-9)
    d_port, o_port, _ = tncg.unproject(model, torch.as_tensor(px))
    np.testing.assert_allclose(d, d_port.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(o, o_port.numpy(), rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        tsdk.CentralGenericCamera.load(path)
