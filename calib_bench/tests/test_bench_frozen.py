"""The frozen copies under calib_bench/ against the port's originals at a
tiny size, and the plain reference against the port's models."""

import math
from unittest import mock

import numpy as np
import pytest
import torch

from calib_bench import peaks, synth
from calib_bench.reference import camera as ref
from calib_bench.tests import tiny
from calib_bench.units import ba_solve


def test_pinhole_grid_is_the_ports():
    from camera_calibration_torch import problems

    for w, h, gw, gh in ((640, 480, 16, 16), (1920, 1080, 79, 45)):
        mine = synth.pinhole_grid(w, h, gw, gh)
        theirs = problems.pinhole_model(w, h, gw, gh, device="cpu",
                                         dtype=torch.float64)
        assert torch.allclose(mine, theirs.grid, atol=1e-15)


def test_grid_resolution_is_the_pipelines():
    from camera_calibration_torch import calibrate

    for size in ((1920, 1080, 25), (640, 480, 10), (160, 120, 20)):
        assert synth.grid_resolution(*size) \
            == calibrate.compute_grid_resolution(*size)
    assert synth.grid_resolution(1920, 1080, 25) == (79, 45)


def test_origin_field_is_the_noncentral_bench_problems():
    from camera_calibration_torch import problems

    with mock.patch.object(problems, "perturb_noncentral_state",
                           lambda state, seed: state):
        state, _, _ = problems.make_noncentral_bench_problem(
            gres=8, n_points=4, n_poses=2, device="cpu",
            dtype=torch.float64)
    assert torch.allclose(synth.origin_field(8, 8),
                          state.intrinsics[0].point_grid, atol=1e-15)


def test_board_corners_of_the_largest_pattern():
    pts = synth.board_corners(72, 50, 0.02, 5)
    assert pts.shape == (3454, 3)
    assert float(pts[:, 0].min()) == pytest.approx(0.02)
    assert float(pts[:, 0].max()) == pytest.approx(71 * 0.02)


def test_view_poses_follow_render_views():
    """The recipe of cli.render_views by its statistics: the translation's
    mean and spread, and the rotation's spread per axis."""
    from camera_calibration_torch import cli
    from camera_calibration_torch.features import pattern as pat

    spec = pat.PatternSpec(num_star_segments=16, squares_x=72, squares_y=50,
                           square_length_in_meters=0.02, tags=[])
    n = 4000
    k = np.array([[0.85 * 1920, 0, 960], [0, 0.85 * 1920, 540], [0, 0, 1.0]])
    ts = np.array([np.linalg.solve(k, hpp)[:, 2] for _, hpp, _ in
                   cli.render_views(spec, n, 1920, 1080, 0.8, 1.6, 3)])
    q, t = synth.view_poses(n, 72, 50, 0.02, 0.8, 1.6,
                            synth.generator(3, 0, "cpu"), "cpu")
    t = t.numpy()
    assert np.allclose(t.mean(0), ts.mean(0), atol=0.01)
    assert np.allclose(t.std(0), ts.std(0), rtol=0.1)
    angle = 2 * np.arctan2(np.linalg.norm(q[:, 1:].numpy(), axis=1),
                           q[:, 0].numpy())
    assert math.isclose(float(np.sqrt(np.mean(angle ** 2) / 3)), 0.12,
                        rel_tol=0.05)


def test_perturbation_scale_is_the_bench_states():
    truth, _, _ = synth.make_problem(tiny.config("cg1080.ba_final"), "cpu")
    pert = {"pose_point_m": 0.003, "direction": 5e-4, "origin_m": 5e-4}
    start = synth.perturb(truth, pert, synth.generator(1, 1, "cpu"))
    d = torch.cat([(start["points"] - truth["points"]).ravel(),
                   (start["rig_t"] - truth["rig_t"]).ravel()])
    assert float(d.std()) == pytest.approx(0.003, rel=0.15)


def test_work_and_bound_are_chip_smokes():
    import chip_smoke

    from calib_bench.work import project

    for blocks in (False, True):
        assert project.work(1000, 4096, 55000, blocks) \
            == chip_smoke.projection_work(1000, 4096, 55000, blocks)
    for nbytes, flops in ((1e9, 1e6), (1e3, 1e12)):
        ms, by = chip_smoke.bound_ms(nbytes, flops)
        s, by2 = peaks.bound_s(nbytes, flops)
        assert s * 1e3 == pytest.approx(ms) and by[:5] == by2[:5]


@pytest.mark.parametrize("cell", list(tiny.CONFIGS))
def test_reference_projection_is_the_ports(cell):
    """In float64 the reference and the port's models put every kept
    corner on the same pixel, to within where the port's projection stops
    (a squared direction error of 1e-12: 1e-6 rad, 1.4e-4 px here)."""
    from camera_calibration_torch.models import protocol

    truth, pixel, kept = synth.make_problem(tiny.config(cell), "cpu")
    start = synth.perturb(truth, tiny.config(cell)["perturbation"],
                          synth.generator(5, 1, "cpu"))
    st = ba_solve.port_state(start)
    model = dataclasses_replace_double(st.intrinsics[0])
    start = ba_solve.reference_state(st, truth["width"], truth["height"])
    p = start["points"].shape[0]
    rows = torch.arange(pixel.shape[0])[kept]
    x = ref.camera_points(start, rows, p)
    mine, ok = ref.project(start, x, pixel[rows])
    theirs, _, valid = protocol.project_points(model, x, init_xy=pixel[rows],
                                               max_iterations=50)
    both = ok & valid
    assert int(both.sum()) >= 0.99 * len(rows)
    assert float((mine - theirs)[both].abs().max()) < 1e-5


def dataclasses_replace_double(model):
    import dataclasses

    return dataclasses.replace(model, **{
        f.name: getattr(model, f.name).double()
        for f in dataclasses.fields(model)
        if torch.is_tensor(getattr(model, f.name))})


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1000.3])
    r = ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -9
    assert abs(float(r[3]) - 1000.3) <= 0.5
