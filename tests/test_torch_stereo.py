"""Port parity: PatchMatch stereo (``stereo/patch_match.py``) and the
``stereo-depth`` command.

The reference package (JAX on the CPU) and the port on the CPU get the
same float64 inputs: ``ba_harness.make_gt_model``'s 7×7-grid
CentralGeneric camera, the slanted textured plane z = 2 + 0.6·x of
``tests/test_stereo.py`` rendered at 48×64 by a rig with a 0.3 m
baseline, and plane fields drawn from a NumPy seed.

The reference's ``compute_depth_map`` is not run whole: XLA compiles its
unrolled PatchMatch loop for minutes.  Held to 1e-9 relative, function by
function (the packages sum in different orders, so last bits differ):

- ``_box_filter`` at radius 1 and 3; ``_warp_cost`` with ZNCC and SSD;
  ``_ray_field_derivative``; ``_slanted_cost`` at window strides 1 and 2
  (cost, validity and the warm pixels);
- ``_plane_sweep_jit`` with 8 levels and 6 polish rounds: the inverse
  depth where the two best levels' costs differ by more than 1e-9 (there
  the winner is not decided by rounding) and the cost everywhere;
- one PatchMatch round, ``_patch_match_round``, given the draws of the
  reference's key schedule (``jax.random`` under ``PRNGKey(seed)``, split
  into the round keys and each round key into ``2·mutation_count + 1``);
  the reference's side is its round rebuilt here from its own
  ``_slanted_cost`` (jitted once) and ``_roll_field``;
- ``lr_consistency_mask``, ``connected_component_filter`` and
  ``median_filter`` exactly, ``bilateral_filter`` to 1e-9;
- ``export_point_cloud``: the same bytes.

``stereo-depth --algorithm plane_sweep --num_levels 8`` through both
command lines (the port with ``--device cpu``) writes the same ``.obj``
and ``.mlp`` bytes.  The port's PatchMatch alone recovers
``tests/test_stereo.py``'s slanted plane at that test's size, options and
bars (its draws differ from the reference's, so its numbers are not held
to the reference's).

The plane-sweep test runs with the command-line test's options (8
levels, 6 polish rounds), so that the reference's sweep compiles once for
both; the stride-1 slanted cost runs on a 3×3 window (see the test).

The module runs with one intra-op thread (``tests/torch_threads.py``).
"""

import dataclasses
import filecmp
import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_harness
import test_stereo as ref_scene
from camera_calibration_torch import cli as tcli
from camera_calibration_torch import convert
from camera_calibration_torch.ba.state import BAState
from camera_calibration_torch.io import state_io as tstate_io
from camera_calibration_torch.stereo import patch_match as tpm
from camera_calibration_tpu import cli as jcli
from camera_calibration_tpu.stereo import patch_match as jpm
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-9
H, W = 48, 64
# the reference's bilateral filter compiled once (op by op it compiles
# each of its ~700 eager operations on first use, ~7 s)
JAX_BILATERAL = jax.jit(jpm.bilateral_filter)
# the command-line test's left and right passes: --num_levels 8
# --iterations 2 --min_depth 0.8 --max_depth 6.0 (default polish rounds)
SWEEP_KW = dict(num_levels=8, iterations=2, min_depth=0.8, max_depth=6.0)
# the slanted cost of the PatchMatch-round test
SLANTED_KW = dict(window_stride=2, min_depth=0.8, max_depth=6.0)
BASELINE = np.array([-0.3, 0.0, 0.0])
R_REL = np.eye(3)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), fin)
    scale = max(np.abs(ref[fin]).max(), 1e-300) if fin.any() else 1.0
    assert np.abs(got[fin] - ref[fin]).max() <= rel * scale


@pytest.fixture(scope="module")
def scene():
    """The rig's model in both packages, both views of the slanted plane,
    the reference camera's rays and the plane's true depth."""
    _, jmodel = ba_harness.make_gt_model(w=W, h=H, grid_res=7)
    tmodel = convert.camera_model(jmodel, device="cpu")
    img_l, depth_gt = ref_scene._render_slanted_view(jmodel, np.eye(3),
                                                     np.zeros(3))
    img_r, _ = ref_scene._render_slanted_view(jmodel, R_REL, BASELINE)
    dirs = tpm.pixel_directions(tmodel, H, W, torch.float64, "cpu")
    return dict(jmodel=jmodel, tmodel=tmodel, img_l=img_l, img_r=img_r,
                depth_gt=depth_gt, dirs=dirs.numpy())


def _planes(scene, seed):
    """A plane field near the slanted truth: tilted normals facing the
    camera and depths off by a few percent."""
    rng = np.random.default_rng(seed)
    dirs = scene["dirs"]
    n = np.array([0.6, 0.0, -1.0]) + rng.normal(0, 0.2, (H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = scene["depth_gt"] * (1 + rng.normal(0, 0.03, (H, W)))
    c = np.einsum("hwj,hwj->hw", n, dirs * z[..., None])
    return n, c


@pytest.mark.parametrize("radius", [1, 3])
def test_box_filter(radius):
    img = np.random.default_rng(radius).normal(0, 1, (24, 32))
    _close(tpm._box_filter(_t(img), radius),
           jpm._box_filter(jnp.asarray(img), radius))


@pytest.mark.parametrize("metric", ["zncc", "ssd"])
def test_warp_cost(scene, metric):
    opts_j = jpm.PatchMatchOptions(metric=metric)
    opts_t = tpm.PatchMatchOptions(metric=metric)
    rng = np.random.default_rng(3)
    inv = 1.0 / scene["depth_gt"] * (1 + rng.normal(0, 0.05, (H, W)))
    args = (scene["img_l"], scene["img_r"], scene["dirs"], inv, R_REL,
            BASELINE)
    cj, vj = jpm._warp_cost(*map(jnp.asarray, args), scene["jmodel"],
                            opts_j)
    ct, vt = tpm._warp_cost(*map(_t, args), scene["tmodel"], opts_t)
    assert np.array_equal(vt.numpy(), np.asarray(vj)) and vt.any()
    _close(ct, cj)


def test_plane_sweep(scene):
    """With the options of the command-line test below (its left pass),
    whose reference sweep is then compiled once for both."""
    kw = SWEEP_KW
    args = (scene["img_l"], scene["img_r"], scene["dirs"], R_REL, BASELINE)
    inv_j, cost_j = jpm._plane_sweep_jit(*map(jnp.asarray, args),
                                         scene["jmodel"],
                                         jpm.PatchMatchOptions(**kw))
    volume = []
    metric = tpm._window_metric

    def record(*a):
        out = metric(*a)
        volume.append(out.clone())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpm, "_window_metric", record)
        inv_t, cost_t = tpm._plane_sweep_jit(*map(_t, args),
                                             scene["tmodel"],
                                             tpm.PatchMatchOptions(**kw))
    best2 = torch.sort(torch.stack(volume[:8]), dim=0).values[:2].numpy()
    # undecided: two finite best costs within 1e-9 (all-inf pixels pick
    # level 0 in both packages)
    with np.errstate(invalid="ignore"):
        decided = ~(np.isfinite(best2[1]) & (
            best2[1] - best2[0] <= 1e-9 * np.maximum(np.abs(best2[0]), 1)))
    assert decided.mean() > 0.9
    inv_j = np.asarray(inv_j)
    assert np.abs(inv_t.numpy() - inv_j)[decided].max() <= REL * inv_j.max()
    _close(cost_t, cost_j)


def test_ray_field_derivative(scene):
    _close(tpm._ray_field_derivative(_t(scene["dirs"])),
           jpm._ray_field_derivative(jnp.asarray(scene["dirs"])))


def _slanted_inputs(scene):
    dirs = scene["dirs"]
    return dict(ref_img=scene["img_l"], other_img=scene["img_r"],
                dirs_ref=dirs,
                ddirs=np.asarray(jpm._ray_field_derivative(
                    jnp.asarray(dirs))),
                r_rel=R_REL, t_rel=BASELINE)


@functools.lru_cache(maxsize=None)
def _jax_slanted(opts):
    """The reference's ``_slanted_cost`` jitted once per options."""
    return jax.jit(lambda *a: jpm._slanted_cost(*a[:8], a[8], a[9], opts))


def _slanted_j(scene, opts, n_f, c_f, warm):
    x = _slanted_inputs(scene)
    return _jax_slanted(opts)(
        *(jnp.asarray(x[k]) for k in ("ref_img", "other_img", "dirs_ref",
                                      "ddirs")),
        jnp.asarray(n_f), jnp.asarray(c_f), jnp.asarray(x["r_rel"]),
        jnp.asarray(x["t_rel"]), scene["jmodel"], jnp.asarray(warm))


def _evaluate_t(scene, opts):
    x = {k: _t(v) for k, v in _slanted_inputs(scene).items()}

    def evaluate(n_c, c_c, warm):
        return tpm._slanted_cost(x["ref_img"], x["other_img"], x["dirs_ref"],
                                 x["ddirs"], n_c, c_c, x["r_rel"],
                                 x["t_rel"], scene["tmodel"], warm, opts)
    return evaluate


def _center(dtype=np.float64):
    return np.zeros((H * W, 2), dtype) + np.array([W * 0.5, H * 0.5])


@pytest.mark.parametrize("kw", [dict(window_stride=1, patch_radius=1),
                                SLANTED_KW])
def test_slanted_cost(scene, kw):
    """Stride 1 on a 3×3 window (every offset of the window: the 7×7
    window only repeats the same per-offset sum 49 times, and XLA takes
    ~15 s to compile that unrolled loop), stride 2 on the 7×7 window."""
    n_f, c_f = _planes(scene, kw["window_stride"])
    cj, vj, wj = _slanted_j(scene, jpm.PatchMatchOptions(**kw), n_f, c_f,
                            _center())
    ct, vt, wt = _evaluate_t(scene, tpm.PatchMatchOptions(**kw))(
        _t(n_f), _t(c_f), _t(_center()))
    assert np.array_equal(vt.numpy(), np.asarray(vj)) and vt.float().mean() > 0.5
    _close(ct, cj)
    _close(wt, wj)


def _jax_round(scene, opts, state, key):
    """The reference's ``one_round`` of ``_patch_match_jit``, op for op,
    from its ``_slanted_cost`` and ``_roll_field``; returns the state and
    the draws it made."""
    n_f, c_f, cost, warm = state
    dirs = jnp.asarray(scene["dirs"])
    h, w = H, W

    def evaluate(n_c, c_c, warm):
        return _slanted_j(scene, jpm.PatchMatchOptions(**SLANTED_KW), n_c,
                          c_c, warm)

    def accept(n_c, c_c, cost_c):
        better = cost_c < cost
        return (jnp.where(better[..., None], n_c, n_f),
                jnp.where(better, c_c, c_f), jnp.where(better, cost_c, cost))

    for (du, dv) in tpm.SHIFTS:
        n_c, c_c = jpm._roll_field(n_f, c_f, du, dv)
        cost_c, _, warm = evaluate(n_c, c_c, warm)
        n_f, c_f, cost = accept(n_c, c_c, cost_c)
    keys = jax.random.split(key, 2 * opts.mutation_count + 1)
    uniforms, normals = [], []
    for mi in range(opts.mutation_count):
        frac = 0.5 ** (mi + 1)
        kd, kn = keys[1 + 2 * mi], keys[2 + 2 * mi]
        nd = jnp.einsum("hwj,hwj->hw", n_f, dirs)
        z = c_f / (jnp.sign(nd) * jnp.maximum(jnp.abs(nd), 1e-9))
        u = jax.random.uniform(kd, (h, w), jnp.float64, -1.0, 1.0)
        uniforms.append(np.asarray(u))
        jitter = 1.0 + frac * 0.5 * u
        z_c = jnp.clip(z * jitter, opts.min_depth, opts.max_depth)
        c_c = c_f / jnp.maximum(jnp.abs(z), 1e-9) * z_c * jnp.sign(z)
        cost_c, _, warm = evaluate(n_f, c_c, warm)
        n_f, c_f, cost = accept(n_f, c_c, cost_c)
        g = jax.random.normal(kn, (h, w, 3), jnp.float64)
        normals.append(np.asarray(g))
        n_c = n_f + frac * g
        n_c = n_c / jnp.maximum(
            jnp.linalg.norm(n_c, axis=-1, keepdims=True), 1e-9)
        facing = jnp.einsum("hwj,hwj->hw", n_c, dirs) < 0
        n_c = jnp.where(facing[..., None], n_c, -n_c)
        nd_f = jnp.einsum("hwj,hwj->hw", n_f, dirs)
        z_f = c_f / (jnp.sign(nd_f) * jnp.maximum(jnp.abs(nd_f), 1e-9))
        c_c = jnp.einsum("hwj,hwj->hw", n_c, dirs * z_f[..., None])
        cost_c, _, warm = evaluate(n_c, c_c, warm)
        n_f, c_f, cost = accept(n_c, c_c, cost_c)
    return (n_f, c_f, cost, warm), uniforms, normals


def test_patch_match_round(scene):
    """The first round of a PatchMatch run of seed 4, from a plane field
    near the truth, given the reference's draws."""
    kw = dict(SLANTED_KW, mutation_count=2, iterations=3, seed=4)
    opts_j, opts_t = jpm.PatchMatchOptions(**kw), tpm.PatchMatchOptions(**kw)
    n_f, c_f = _planes(scene, 9)
    cost, _, warm = _slanted_j(scene, jpm.PatchMatchOptions(**SLANTED_KW),
                               n_f, c_f, _center())
    rk = jax.random.split(jax.random.PRNGKey(opts_j.seed),
                          opts_j.iterations)[0]
    (nj, cj, costj, warmj), uniforms, normals = _jax_round(
        scene, opts_j, (jnp.asarray(n_f), jnp.asarray(c_f), cost, warm), rk)
    nt, ct, costt, warmt = tpm._patch_match_round(
        _evaluate_t(scene, opts_t), _t(scene["dirs"]),
        (_t(n_f), _t(c_f), _t(cost), _t(warm)),
        [_t(u) for u in uniforms], [_t(g) for g in normals], opts_t)
    changed = np.asarray(costj) < np.asarray(cost)
    assert changed.mean() > 0.3
    for got, ref in ((nt, nj), (ct, cj), (costt, costj), (warmt, warmj)):
        _close(got, ref)


def _result(scene, depth):
    return {"depth": depth, "dirs": scene["dirs"],
            "inv_depth": 1.0 / depth}


def test_lr_consistency_and_filters(scene):
    rng = np.random.default_rng(11)
    depth_l = scene["depth_gt"] * (1 + rng.normal(0, 0.01, (H, W)))
    depth_l[::7, ::5] *= 1.5  # outliers
    # the right camera's depth of the same plane, rendered along its rays
    _, depth_r = ref_scene._render_slanted_view(scene["jmodel"], R_REL,
                                                BASELINE)
    depth_r = depth_r * (1 + rng.normal(0, 0.01, (H, W)))
    rj = [{k: jnp.asarray(v) for k, v in _result(scene, d).items()}
          for d in (depth_l, depth_r)]
    rt = [{k: _t(v) for k, v in _result(scene, d).items()}
          for d in (depth_l, depth_r)]
    mj = jpm.lr_consistency_mask(rj[0], rj[1], scene["jmodel"],
                                 scene["jmodel"], (R_REL, BASELINE))
    mt = tpm.lr_consistency_mask(rt[0], rt[1], scene["tmodel"],
                                 scene["tmodel"], (R_REL, BASELINE))
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert 0.3 < np.asarray(mj).mean() < 0.98
    inv = 1.0 / depth_l
    _close(tpm.bilateral_filter(_t(inv), _t(scene["img_l"])),
           JAX_BILATERAL(jnp.asarray(inv), jnp.asarray(scene["img_l"])))
    speckled = inv.copy()
    speckled[5:7, 30:32] = 5.0
    mask = np.asarray(mj)
    for args in ((mask, speckled, 20), (mask, inv, 50), (mask[:0], inv[:0])):
        got = tpm.connected_component_filter(*map(_t, args[:2]), *args[2:])
        assert np.array_equal(got, jpm.connected_component_filter(*args))
    assert np.array_equal(tpm.median_filter(_t(inv)).numpy(),
                          np.asarray(jpm.median_filter(jnp.asarray(inv))))


def test_export_point_cloud_bytes(scene, tmp_path, monkeypatch):
    """Written in chunks of 1000 points (several per file here)."""
    monkeypatch.setattr(tpm, "EXPORT_CHUNK", 1000)
    rng = np.random.default_rng(5)
    depth = scene["depth_gt"] * (1 + rng.normal(0, 0.01, (H, W)))
    mask = rng.uniform(size=(H, W)) < 0.7
    for i, (m, colors) in enumerate([(None, None), (mask, scene["img_l"]),
                                     (mask, np.stack([scene["img_l"]] * 3,
                                                     -1))]):
        a, b = tmp_path / f"port{i}.obj", tmp_path / f"ref{i}.obj"
        tpm.export_point_cloud(
            a, {k: _t(v) for k, v in _result(scene, depth).items()},
            mask=None if m is None else _t(m), colors=colors)
        jpm.export_point_cloud(b, _result(scene, depth), mask=m,
                               colors=colors)
        assert filecmp.cmp(a, b, shallow=False), i


def test_stereo_depth_command_matches_reference(scene, tmp_path, capsys,
                                                monkeypatch):
    """Both command lines on a saved two-camera rig (camera 1 at the
    baseline) and two PNG views of the slanted plane (the reference's
    bilateral filter jitted, as above)."""
    monkeypatch.setattr(jpm, "bilateral_filter", JAX_BILATERAL)
    tmodel = scene["tmodel"]
    state = BAState(
        rig_q_global=torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64),
        rig_t_global=torch.zeros((1, 3), dtype=torch.float64),
        cam_q_rig=torch.tensor([[1.0, 0, 0, 0]] * 2, dtype=torch.float64),
        cam_t_rig=_t(np.stack([np.zeros(3), BASELINE])),
        points=torch.zeros((1, 3), dtype=torch.float64),
        intrinsics=(tmodel, tmodel))
    tstate_io.save_ba_state(tmp_path / "rig", state, [True], {0: 0})
    paths = []
    for name, img in (("left", scene["img_l"]), ("right", scene["img_r"])):
        paths.append(str(tmp_path / f"{name}.png"))
        cv2.imwrite(paths[-1], np.round(img * 255).astype(np.uint8))
    outs = []
    for pkg, extra in (("ref", []), ("port", ["--device", "cpu"])):
        (tmp_path / pkg).mkdir()
        argv = ["stereo-depth", "--state_directory", str(tmp_path / "rig"),
                "--left_image", paths[0], "--right_image", paths[1],
                "--output", str(tmp_path / pkg / "cloud.obj"),
                "--algorithm", "plane_sweep", "--num_levels", "8",
                "--iterations", "2", "--min_depth", "0.8",
                "--max_depth", "6.0",
                "--min_component_size", "20"]
        main = jcli.main if pkg == "ref" else tcli.main
        assert main(argv + extra) == 0
        outs.append(capsys.readouterr().out.replace(f"/{pkg}/", "/"))
    assert outs[0] == outs[1]
    assert int(outs[0].split(": ")[1].split()[0]) > 0
    for name in ("cloud.obj", "cloud.mlp"):
        assert filecmp.cmp(tmp_path / "ref" / name, tmp_path / "port" / name,
                           shallow=False), name


def test_port_patch_match_beats_plane_sweep(scene, monkeypatch):
    """``tests/test_stereo.py::test_slanted_patch_match_beats_plane_sweep``
    on the port alone, with that test's camera, views, options and bars:
    PatchMatch's median relative depth error under 0.02 and under 0.7×
    the plane sweep's, the median |n·n_gt| above 0.95.  The plane sweep's
    result is the sweep that PatchMatch starts from (what
    ``algorithm="plane_sweep"`` returns), recorded in the same run."""
    sweeps = []
    sweep = tpm._plane_sweep_jit
    monkeypatch.setattr(tpm, "_plane_sweep_jit",
                        lambda *a: sweeps.append(sweep(*a)) or sweeps[-1])
    opts = tpm.PatchMatchOptions(iterations=4, num_levels=32, patch_radius=3,
                                 window_stride=2, mutation_count=1,
                                 min_depth=0.8, max_depth=6.0, seed=2)
    res = tpm.compute_depth_map(_t(scene["img_l"]), _t(scene["img_r"]),
                                scene["tmodel"], scene["tmodel"],
                                (R_REL, BASELINE), opts)
    inv_ps, cost_ps = sweeps[0]
    interior = np.zeros((H, W), bool)
    interior[10:-10, 10:-10] = True
    gt = scene["depth_gt"]

    def med_rel(depth, cost):
        good = interior & np.isfinite(cost)
        return np.median(np.abs(depth[good] - gt[good]) / gt[good])

    e_pm = med_rel(res["depth"].numpy(), res["cost"].numpy())
    e_ps = med_rel(1.0 / np.maximum(inv_ps.numpy(), 1e-9), cost_ps.numpy())
    assert e_pm < 0.02, (e_pm, e_ps)
    assert e_pm < 0.7 * e_ps, (e_pm, e_ps)
    n_gt = np.array([0.6, 0.0, -1.0]) / np.hypot(0.6, 1.0)
    dots = np.abs(res["normals"].numpy()[interior] @ n_gt)
    assert np.median(dots) > 0.95, np.median(dots)


def test_compute_depth_map_refuses_an_unknown_algorithm(scene):
    with pytest.raises(ValueError, match="algorithm"):
        tpm.compute_depth_map(_t(scene["img_l"]), _t(scene["img_r"]),
                              scene["tmodel"], scene["tmodel"],
                              (R_REL, BASELINE), algorithm="census")


def test_options_match_reference():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        tpm.PatchMatchOptions)] == [(f.name, f.default) for f in
                                    dataclasses.fields(jpm.PatchMatchOptions)])
