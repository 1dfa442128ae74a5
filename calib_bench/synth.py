"""The benchmark's own generators: a calibration deployment made on the
device from a seed.

Frozen copies, rewritten in PyTorch, of the recipes the port's problems and
command line use, so that a later change to the program cannot move the
yardstick:

- :func:`pinhole_grid` is ``camera_calibration_torch.problems.pinhole_model``'s
  direction grid (a pinhole camera, fx = fy = 0.85·w, sampled at the knots);
- :func:`origin_field` is the line-origin field of
  ``problems.make_noncentral_bench_problem``;
- :func:`grid_resolution` is ``calibrate.compute_grid_resolution``;
- :func:`board_corners` lays out a star pattern's corners (the inner
  corners of a squares_x × squares_y board, less the block a central tag
  covers);
- :func:`view_poses` draws views by the recipe of ``cli.render_views``:
  rotation Rodrigues(N(0, 0.12) per axis), the board centred ± N(0, 0.05) m
  at a depth uniform in [min_z, max_z];
- :func:`perturb` is ``problems.perturb_bench_state`` (poses' translations
  and points moved by N(0, σ)), widened to the intrinsics (each knot
  direction moved by N(0, σ_dir) per component and renormalized, each
  line origin by N(0, σ_origin)).

Every draw comes from a ``torch.Generator`` on the device, in a few large
calls.  The deployment (the views' poses, the observation noise and the
solves' start states) comes from the configuration's ``deployment_seed``,
so every run does the same work; a run's seed picks the order in which
its solves take the start states.  Geometry is float64; :func:`make_problem`
projects the corners through the true generic camera with the plain
reference (``reference.camera``).
"""

from __future__ import annotations

import torch

from calib_bench.reference import camera as ref

SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream)) & SEED_MASK)
    return g


def grid_resolution(width, height, approx_pixels_per_cell,
                    exterior_cells_per_side=1):
    """(grid width, grid height) of a generic model with cells of about
    ``approx_pixels_per_cell`` pixels and one exterior cell a side."""
    border = 2 * exterior_cells_per_side
    return (int(width / approx_pixels_per_cell + 0.5) + border,
            int(height / approx_pixels_per_cell + 0.5) + border)


def pinhole_grid(width, height, gw, gh, focal_factor=0.85, device=None,
                 dtype=torch.float64):
    """(gh, gw, 3) unit directions of a pinhole camera (fx = fy =
    focal_factor·width, principal point at the image centre) at the knots of
    a grid with a one-cell border: knot (x, y) sits at pixel
    ((x − 1)·w/(gw − 3), (y − 1)·h/(gh − 3))."""
    f = focal_factor * width
    yy, xx = torch.meshgrid(torch.arange(gh, dtype=dtype, device=device),
                            torch.arange(gw, dtype=dtype, device=device),
                            indexing="ij")
    px = (xx - 1.0) / (gw - 3.0) * width
    py = (yy - 1.0) / (gh - 3.0) * height
    dirs = torch.stack([(px - width / 2) / f, (py - height / 2) / f,
                        torch.ones_like(px)], -1)
    return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


def origin_field(gw, gh, amplitude=0.002, device=None, dtype=torch.float64):
    """(gh, gw, 3) line origins (a·sin(x/2), a·cos(y/2), 0) over the knot
    indices (x, y)."""
    yy, xx = torch.meshgrid(torch.arange(gh, dtype=dtype, device=device),
                            torch.arange(gw, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([amplitude * torch.sin(xx / 2.0),
                        amplitude * torch.cos(yy / 2.0),
                        torch.zeros_like(xx)], -1)


def board_corners(squares_x, squares_y, square_m, tag_corners, device=None,
                  dtype=torch.float64):
    """(P, 3) board-frame corners (c·s, r·s, 0) of the inner corners
    c = 1..squares_x − 1, r = 1..squares_y − 1, less the tag_corners ×
    tag_corners block around the centre corner."""
    cs = torch.arange(1, squares_x, device=device)
    rs = torch.arange(1, squares_y, device=device)
    r, c = torch.meshgrid(rs, cs, indexing="ij")
    half = tag_corners // 2
    keep = ~(((c - squares_x // 2).abs() <= half)
             & ((r - squares_y // 2).abs() <= half)) if tag_corners else \
        torch.ones_like(c, dtype=torch.bool)
    c, r = c[keep].to(dtype), r[keep].to(dtype)
    return torch.stack([c * square_m, r * square_m, torch.zeros_like(c)], -1)


def axis_angle_quat(a):
    """(…, 4) unit quaternions (w, x, y, z) of rotation vectors (…, 3)."""
    th = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    half = 0.5 * th
    k = torch.where(th > 1e-12, torch.sin(half) / torch.clamp_min(th, 1e-300),
                    torch.full_like(th, 0.5))
    return torch.cat([torch.cos(half), k * a], -1)


def view_poses(n_views, squares_x, squares_y, square_m, min_z, max_z, gen,
               device, dtype=torch.float64):
    """(q (M, 4), t (M, 3)): board-to-camera poses x_cam = R(q)·X + t of the
    recipe of ``render_views``: rotation vector N(0, 0.12) per axis,
    t = (−off_x + N(0, 0.05), −off_y + N(0, 0.05), U(min_z, max_z)) with
    off = ((squares − 1)·s/2)."""
    rot = torch.randn((n_views, 3), generator=gen, device=device,
                      dtype=dtype) * 0.12
    shift = torch.randn((n_views, 2), generator=gen, device=device,
                        dtype=dtype) * 0.05
    depth = min_z + (max_z - min_z) * torch.rand(
        (n_views,), generator=gen, device=device, dtype=dtype)
    off = torch.tensor([(squares_x - 1) * square_m / 2,
                        (squares_y - 1) * square_m / 2], dtype=dtype,
                       device=device)
    t = torch.cat([shift - off, depth[:, None]], -1)
    return axis_angle_quat(rot), t


def perturb(truth, pert, gen):
    """A start state: ``truth`` (a reference state dict, float64) with
    ``pert``'s noise drawn from ``gen``: rig translations and points by
    N(0, pert["pose_point_m"]), knot directions by N(0, pert["direction"])
    per component (renormalized), line origins by N(0, pert["origin_m"])."""
    dev, dt = truth["points"].device, truth["points"].dtype

    def noise(shape, sigma):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt) * sigma

    s = float(pert["pose_point_m"])
    dirs = truth["directions"] + noise(truth["directions"].shape,
                                       float(pert["direction"]))
    out = dict(truth)
    out["rig_t"] = truth["rig_t"] + noise(truth["rig_t"].shape, s)
    out["points"] = truth["points"] + noise(truth["points"].shape, s)
    out["directions"] = dirs / torch.linalg.vector_norm(dirs, dim=-1,
                                                        keepdim=True)
    if truth.get("origins") is not None:
        out["origins"] = truth["origins"] + noise(
            truth["origins"].shape, float(pert["origin_m"]))
    return out


def make_problem(cfg, device):
    """The deployment of configuration ``cfg`` on ``device``: (truth state
    dict, observed pixels (M·P, 2) float64, kept (M·P,) bool), in (view ×
    corner) grid layout.  A slot is
    kept where the true camera sees its corner 1 px inside the image; its
    pixel is the exact projection plus N(0, noise_px) per axis."""
    cam, board = cfg["camera"], cfg["board"]
    w, h = int(cam["width"]), int(cam["height"])
    gw, gh = grid_resolution(w, h, cfg["model"]["approx_pixels_per_cell"])
    gen = generator(cfg["deployment_seed"], 0, device)
    directions = pinhole_grid(w, h, gw, gh, cam["focal_factor"], device)
    field = cfg["model"].get("origin_amplitude_m")
    origins = None if field is None else origin_field(gw, gh, field, device)
    points = board_corners(board["squares_x"], board["squares_y"],
                           board["square_m"], board["tag_corners"], device)
    q, t = view_poses(cfg["views"]["count"], board["squares_x"],
                      board["squares_y"], board["square_m"],
                      cfg["views"]["min_z_m"], cfg["views"]["max_z_m"], gen,
                      device)
    truth = {"rig_q": q, "rig_t": t, "points": points,
             "directions": directions, "origins": origins,
             "width": w, "height": h}
    m, p = q.shape[0], points.shape[0]
    # the pinhole pixel starts the exact projection through the generic model
    x_cam = ref.camera_points(truth, torch.arange(m * p, device=device), p)
    f = cam["focal_factor"] * w
    z = x_cam[:, 2]
    start = torch.stack([f * x_cam[:, 0] / z + w / 2,
                         f * x_cam[:, 1] / z + h / 2], -1)
    ahead = z > 0.1
    start = torch.where(ahead[:, None], start, torch.zeros_like(start))
    px, ok = ref.project(truth, x_cam, start)
    kept = (ahead & ok & (px[:, 0] > 1) & (px[:, 0] < w - 1)
            & (px[:, 1] > 1) & (px[:, 1] < h - 1))
    noise = torch.randn((m * p, 2), generator=gen, device=device,
                        dtype=torch.float64) * float(cfg["noise_px"])
    pixel = torch.where(kept[:, None], px + noise, torch.zeros_like(px))
    return truth, pixel, kept
