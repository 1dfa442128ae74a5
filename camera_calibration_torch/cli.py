"""Command-line interface of the port.

The counterpart of the reference package's ``cli.py``, flag for flag, for
the subcommands whose modules are ported:

  calibrate                full pipeline: [detect] -> dense init -> pyramid BA
  record                   live capture: cameras/videos/directories -> dataset
  report                   calibration report for a saved state
  compare                  direction comparison of two saved states
  compare-reconstructions  Umeyama-aligned pose and intrinsics comparison
  fit-parametric           fit parametric models to a generic calibration
  localization-accuracy    Monte-Carlo localization accuracy vs a reference
  create-legends           legend images of the report visualizations
  intersect-datasets       keep features present in all datasets
  convert-dataset          dataset.bin <-> JSON
  create-pattern           generate a star pattern (YAML, vector PDF, PNG)
  render-synthetic         render seeded views of a pattern
  extract-features         detector only: image directories -> dataset.bin
  stereo-depth             PatchMatch depth on a calibrated stereo rig
  export-colmap            export a saved state as a COLMAP text model
  refine-colmap            bundle-adjust a COLMAP model
  compare-point-clouds     align and compare two .obj point clouds
  visualize-calibration    direction and distortion images of a calibration

Each command prints what its reference counterpart prints.  The commands
that compute take ``--device`` (default: the card; they raise without one,
never dropping to the CPU).  ``calibrate --dtype mixed`` (the default)
runs the pipeline in float32 on the device and polishes in float64 on the
CPU; ``float64`` runs on ``--device`` in float64 (the card's kernels take
float32 only, so that is ``--device cpu``).  ``report``,
``stereo-depth`` and ``refine-colmap`` work in the device's type: float32
on the card (the projection kernel), float64 on the CPU.
The state-reading tools (compare, compare-reconstructions, fit-parametric,
localization-accuracy, visualize-calibration) load the states in float64,
as the reference does.  Reports, legends and visualizations are rasters
written with OpenCV, not matplotlib, and so are the per-stage images of
``calibrate --live_directory`` (the headless CalibrationWindow).
``record`` detects on ``--device`` frame by frame and keeps its host work
(coverage maps, recording) in NumPy.

For example, ``python -m camera_calibration_torch.cli calibrate
--dataset_files dataset.bin --output_directory out --report``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".tif")


def _load_gray(path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def detect_dataset(image_dirs, pattern_files, device=None, dtype=None,
                   visualizer=None):
    """Run the feature detector over image directories (one per camera,
    the i-th image of each forming imageset i) -> Dataset.  With a
    ``visualizer`` (ui.calibration_visualizer) each image's detections are
    drawn."""
    import torch

    from camera_calibration_torch.ba.dataset import (Dataset, Imageset,
                                                     KnownGeometry)
    from camera_calibration_torch.features import detector as fdet
    from camera_calibration_torch.features import pattern as pat

    patterns = [pat.load_pattern_yaml(p) for p in pattern_files]
    det = fdet.FeatureDetector(patterns, device=device,
                               dtype=dtype or torch.float32)
    corner_maps = det.corner_maps

    per_cam_files = [
        sorted(f for f in glob.glob(os.path.join(d, "*"))
               if f.lower().endswith(IMAGE_SUFFIXES))
        for d in image_dirs
    ]
    n_sets = min(len(f) for f in per_cam_files)
    n_cameras = len(image_dirs)

    # each camera's images in one batch: the growth rings of all images
    # share the refinement batches (FeatureDetector.detect_batch)
    image_sizes = []
    per_cam_features = []
    for ci in range(n_cameras):
        imgs = [_load_gray(per_cam_files[ci][si]) for si in range(n_sets)]
        image_sizes.append((imgs[0].shape[1], imgs[0].shape[0]))
        feats = []
        for si, (features, _) in enumerate(det.detect_batch(imgs)):
            print(f"[detect] camera {ci} image {si}: {len(features)} "
                  f"features ({os.path.basename(per_cam_files[ci][si])})")
            if visualizer is not None:
                visualizer.update_feature_detection(ci, imgs[si], features)
            feats.append(features)
        per_cam_features.append(feats)
    imagesets = [
        Imageset(
            features=[per_cam_features[ci][si] for ci in range(n_cameras)],
            filenames=[os.path.basename(per_cam_files[ci][si])
                       for ci in range(n_cameras)],
        )
        for si in range(n_sets)
    ]
    geoms = [
        KnownGeometry(cell_length_in_meters=spec.square_length_in_meters,
                      feature_id_to_position=dict(corner_maps[pi]))
        for pi, spec in enumerate(patterns)
    ]
    return Dataset(num_cameras=n_cameras, image_sizes=image_sizes,
                   imagesets=imagesets, known_geometries=geoms)


def cmd_extract_features(args):
    import torch

    from camera_calibration_torch.io import dataset_bin

    dataset = detect_dataset(
        args.image_directories.split(","), args.pattern_files.split(","),
        device=args.device, dtype=getattr(torch, args.dtype))
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    dataset_bin.save_dataset(args.output, dataset)
    n = sum(len(f) for s in dataset.imagesets for f in s.features)
    print(f"saved {args.output}: {len(dataset.imagesets)} imagesets, "
          f"{n} features")
    return 0


def cmd_create_pattern(args):
    import cv2
    import numpy as np

    from camera_calibration_torch.features import pattern as pat

    tags = []
    if args.apriltags:
        # one tag in the middle, like the reference default patterns
        tw = max(2, args.squares_x // 5)
        tags = [pat.AprilTagInfo(x=(args.squares_x - tw) // 2,
                                 y=(args.squares_y - tw) // 2,
                                 width=tw, height=tw,
                                 index=args.first_tag_index)]
    spec = pat.PatternSpec(
        num_star_segments=args.num_star_segments,
        squares_x=args.squares_x,
        squares_y=args.squares_y,
        square_length_in_meters=args.square_length_in_meters,
        tags=tags,
    )
    os.makedirs(args.output_directory, exist_ok=True)
    base = os.path.join(
        args.output_directory,
        f"pattern_resolution_{args.squares_x}x{args.squares_y}"
        f"_segments_{args.num_star_segments}",
    )
    pat.save_pattern_yaml(spec, base + ".yaml")
    # print-ready vector PDF at true physical scale
    pat.save_pattern_pdf(spec, base + ".pdf")
    # plus a raster preview at the requested resolution
    px_per_square = args.dpi_pixels_per_square
    h_img = np.array([[1.0 / px_per_square, 0.0, -1.5],
                      [0.0, 1.0 / px_per_square, -1.5],
                      [0.0, 0.0, 1.0]])
    w = px_per_square * (spec.squares_x + 1)
    h = px_per_square * (spec.squares_y + 1)
    img = pat.render_pattern(
        spec, h_img, (w, h), supersample=2,
        tag_renderer=pat.make_tag_renderer(spec) if tags else None,
    )
    cv2.imwrite(base + ".png", (img * 255).astype(np.uint8))
    print(f"wrote {base}.yaml, {base}.pdf and {base}.png")
    return 0


def _rodrigues(a):
    import numpy as np

    th = np.linalg.norm(a)
    if th < 1e-12:
        return np.eye(3)
    k = a / th
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx


def render_views(spec, num_images, width, height, min_z, max_z, seed):
    """The seeded pinhole views of ``render-synthetic``: yields (index,
    pattern-to-pixel homography of the feature coords, the NumPy
    generator to draw that view's degradations from), in order.

    The camera has fx = fy = 0.85·width and its principal point at the
    image center; each view's rotation is Rodrigues of N(0, 0.12) per axis
    and its translation centers the board ± N(0, 0.05) m at a depth
    uniform in [min_z, max_z]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fx = fy = 0.85 * width
    k_mat = np.array([[fx, 0, 0.5 * width], [0, fy, 0.5 * height],
                      [0, 0, 1.0]])
    cell = spec.square_length_in_meters
    off_x = (spec.squares_x - 1) * cell / 2
    off_y = (spec.squares_y - 1) * cell / 2
    for i in range(num_images):
        r = _rodrigues(rng.normal(0, 0.12, 3))
        t = np.array([-off_x + rng.normal(0, 0.05),
                      -off_y + rng.normal(0, 0.05),
                      rng.uniform(min_z, max_z)])
        yield i, k_mat @ np.c_[r[:, :2] * cell, t], rng


def _render_view(spec, h_pp, size, rng, degradations, path):
    """Render, degrade and write one view of ``render-synthetic``."""
    import cv2
    import numpy as np

    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.features.degrade import degrade

    img = pat.render_pattern(
        spec, np.linalg.inv(h_pp), size, supersample=3,
        tag_renderer=pat.make_tag_renderer(spec) if spec.tags else None)
    img = degrade(img, rng, **degradations)
    cv2.imwrite(path, (img * 255).astype(np.uint8))


def cmd_render_synthetic(args):
    """Render a synthetic dataset of pattern views from a pinhole camera
    (the reference's tools/render_synthetic_dataset.cc).

    The views render in one thread per available core (NumPy and OpenCV
    release the GIL).  Each view's degradations draw from one generator
    in view order, so for a thread the parent hands over a copy of the
    generator and advances its own past the view's draws by degrading a
    blank image (see :func:`degrade`): the files are the same bytes as
    in one thread."""
    import copy

    import numpy as np

    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.features.degrade import degrade

    spec = pat.load_pattern_yaml(args.pattern_file)
    w, h = args.width, args.height
    os.makedirs(args.output_directory, exist_ok=True)
    degradations = dict(vignetting=args.vignetting,
                        defocus_sigma=args.defocus_sigma,
                        jpeg_quality=args.jpeg_quality,
                        exposure_drift=args.exposure_drift, noise=args.noise)
    views = render_views(spec, args.num_images, w, h, args.min_z, args.max_z,
                         args.seed)
    workers = min(len(os.sched_getaffinity(0)), args.num_images)
    if workers <= 1:
        for i, h_pp, rng in views:
            _render_view(spec, h_pp, (w, h), rng, degradations,
                         os.path.join(args.output_directory,
                                      f"synthetic_{i:04d}.png"))
    else:
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            pending = []
            for i, h_pp, rng in views:
                pending.append(pool.submit(
                    _render_view, spec, h_pp, (w, h), copy.deepcopy(rng),
                    degradations, os.path.join(args.output_directory,
                                               f"synthetic_{i:04d}.png")))
                degrade(np.zeros((h, w)), rng, **degradations)
            for done in pending:
                done.result()
    print(f"rendered {args.num_images} images to {args.output_directory}")
    return 0


def _dtype(name):
    import torch

    return torch.float64 if name == "float64" else torch.float32


def _dense_initialization(dataset, model_kind, seed, cache_path):
    """Per-camera initialization results: loaded from the ``.npz`` cache
    at ``cache_path`` when it matches the dataset, else computed (and
    saved there).  None when a camera fails."""
    from camera_calibration_torch.init.dense_init import (
        DenseInitializer, DenseInitOptions, load_dense_init, save_dense_init)
    from camera_calibration_torch.init.noncentral_init import (
        NoncentralDenseInitializer)

    cache_file = cache_path and (cache_path if cache_path.endswith(".npz")
                                 else cache_path + ".npz")
    if cache_file and os.path.exists(cache_file):
        try:
            cached = load_dense_init(cache_file)
        except Exception as e:  # a damaged cache is recomputed
            print(f"[init] could not load cache {cache_file}: {e}")
            cached = None
        if cached is not None and (
                len(cached) != dataset.num_cameras
                or any(r is not None
                       and len(r.image_used) != len(dataset.imagesets)
                       for r in cached)):
            print("[init] cache does not match the dataset; recomputing")
            cached = None
        if cached is not None:
            print(f"[init] loaded dense initialization from {cache_file}")
            return cached

    initializer = (NoncentralDenseInitializer
                   if model_kind == "noncentral_generic" else DenseInitializer)
    results = []
    for ci in range(dataset.num_cameras):
        res = initializer(dataset, ci, DenseInitOptions(seed=seed)).run()
        if res is None:
            print(f"dense initialization failed for camera {ci}")
            return None
        print(f"[init] camera {ci}: {sum(res.image_used)}/"
              f"{len(dataset.imagesets)} imagesets localized")
        results.append(res)
    if cache_file:
        save_dense_init(cache_path, results)
        print(f"[init] saved dense initialization to {cache_file}")
    return results


def _calibrate_options(args, num_pyramid_levels, polish_iterations):
    from camera_calibration_torch import calibrate as cal

    return cal.CalibrateOptions(
        num_pyramid_levels=num_pyramid_levels,
        approx_pixels_per_cell=args.approx_pixels_per_cell,
        outlier_removal_factor=args.outlier_removal_factor,
        final_iterations=args.final_iterations,
        freeze=("points", "intrinsics") if args.localize_only else (),
        lm_steps_per_call=args.lm_steps_per_call,
        solver=args.solver,
        block_chunk=args.block_chunk,
        cg_warm_start=args.cg_warm_start,
        proj_iterations=args.proj_iterations,
        polish_iterations=polish_iterations,
    )


def cmd_calibrate(args):
    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch.ba.dataset import build_per_camera_tables
    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.init.state_init import (
        build_ba_state, feature_id_to_point_index)
    from camera_calibration_torch.io import dataset_bin, state_io

    device = default_device(args.device)
    # "mixed" (the default): the pipeline in float32 on the device, then
    # float64 polish iterations on the CPU (calibrate.polish_float64)
    dtype = _dtype(args.dtype)
    polish_iterations = args.polish_iterations if args.dtype == "mixed" else 0

    visualizer = None
    if args.live_directory:
        from camera_calibration_torch.ui.calibration_visualizer import (
            CalibrationVisualizer)

        visualizer = CalibrationVisualizer(args.live_directory)

    # 1. dataset: files merged into one joint dataset, or detection
    if args.dataset_files:
        dataset = dataset_bin.load_datasets(args.dataset_files)
        n_merged = len(args.dataset_files.split(","))
        if n_merged > 1:
            print(f"[dataset] merged {n_merged} files: "
                  f"{len(dataset.imagesets)} imagesets, "
                  f"{len(dataset.known_geometries)} known geometries")
    else:
        if not (args.image_directories and args.pattern_files):
            print("need --dataset_files or --image_directories + "
                  "--pattern_files")
            return 1
        dataset = detect_dataset(args.image_directories.split(","),
                                 args.pattern_files.split(","),
                                 device=device, dtype=dtype,
                                 visualizer=visualizer)
        os.makedirs(args.output_directory, exist_ok=True)
        dataset_bin.save_dataset(
            os.path.join(args.output_directory, "dataset.bin"), dataset)
    os.makedirs(args.output_directory, exist_ok=True)
    state_path = os.path.join(args.output_directory, "state")

    # 2. the initial state: a saved one, or dense initialization
    if args.state_directory:
        state, used, fid_to_idx = state_io.load_ba_state(
            args.state_directory, dtype=dtype, device=device)
        if not fid_to_idx:
            fid_to_idx = feature_id_to_point_index(dataset)
        data = build_per_camera_tables(dataset, fid_to_idx, image_used=used,
                                       dtype=dtype, device=device)
        print(f"[resume] loaded state from {args.state_directory}")
        # an explicit --model resamples (or converts) the loaded models to
        # the coarsest level of the requested pyramid, which then runs
        # whole; without it a resume continues at the loaded resolution
        n_pyramid = 1
        if args.model is not None and not args.localize_only:
            resampled = cal.resample_models_if_necessary(
                state, args.model, args.approx_pixels_per_cell,
                args.num_pyramid_levels - 1)
            if resampled is not state:
                state = resampled
                n_pyramid = args.num_pyramid_levels
        if len(used) < state.rig_q_global.shape[0]:
            used = list(used) + [True] * (
                state.rig_q_global.shape[0] - len(used))
        state, data, rep = cal.calibrate(
            state, data, _calibrate_options(args, n_pyramid,
                                            polish_iterations),
            known_geometries=dataset.known_geometries,
            feature_id_to_point_index=fid_to_idx,
            state_output_path=state_path, image_used=used,
            visualizer=visualizer)
        print("[calibrate] report:", {
            k: v for k, v in rep.items() if not isinstance(v, list)})
        state_io.save_ba_state(state_path, state, used, fid_to_idx)
        return 0

    model_kind = args.model or "central_generic"
    # the grid pyramid runs for both grid model families; parametric
    # models calibrate at their final parameterization directly
    n_pyramid = (args.num_pyramid_levels
                 if model_kind in ("central_generic", "noncentral_generic")
                 else 1)
    results = _dense_initialization(dataset, model_kind, args.seed,
                                    args.dense_initialization_base_path)
    if results is None:
        return 1
    if visualizer is not None:
        for ci, res in enumerate(results):
            if hasattr(res, "observation_directions"):
                dirs, valid = res.observation_directions()
                visualizer.update_initialization(ci, dirs, valid)

    # 3. the initial state at the coarsest pyramid resolution
    full_res = cal.compute_grid_resolution(
        dataset.image_sizes[0][0], dataset.image_sizes[0][1],
        args.approx_pixels_per_cell)
    coarse = cal.grid_resolution_for_level(n_pyramid - 1, *full_res)
    state, data, fid_to_idx, image_used = build_ba_state(
        dataset, results, (max(4, coarse[1]), max(4, coarse[0])),
        dtype=dtype, model_kind=model_kind, device=device)

    # 4. calibrate, 5. save the state and the report
    state, data, rep = cal.calibrate(
        state, data, _calibrate_options(args, n_pyramid, polish_iterations),
        known_geometries=dataset.known_geometries,
        feature_id_to_point_index=fid_to_idx,
        state_output_path=state_path, image_used=image_used,
        visualizer=visualizer)
    print("[calibrate] report:", {
        k: v for k, v in rep.items() if not isinstance(v, list)})
    state_io.save_ba_state(state_path, state, image_used, fid_to_idx)
    if args.report:
        from camera_calibration_torch.report.calibration_report import (
            create_calibration_report)

        metrics = create_calibration_report(
            os.path.join(args.output_directory, "report"), state, data,
            num_total_imagesets=len(dataset.imagesets))
        for ci, m in enumerate(metrics):
            print(f"[report] camera {ci}: median "
                  f"{m['reprojection_error_median']:.4f} px, avg "
                  f"{m['reprojection_error_average']:.4f} px")
    return 0


def cmd_record(args):
    """Live capture: camera/video/directory inputs -> detection -> dataset.

    The headless replacement for the reference's live-capture GUI mode
    (reference: main.cc:487-600 live bootstrap + ui/live_image_consumer.cc):
    frames stream from the inputs, features are detected live on
    ``--device`` (default: the card), imagesets with detections accumulate
    into a dataset.bin, images are optionally recorded, and per-camera
    detection-coverage PNGs give the operator feedback on which image
    regions still need views.
    """
    from camera_calibration_torch.ba.dataset import Dataset, KnownGeometry
    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.features import detector as fdet
    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.io import dataset_bin
    from camera_calibration_torch.io.image_input import create_image_input
    from camera_calibration_torch.ui.live_capture import (
        LiveCaptureOptions, LiveImageConsumer, run_live_capture)

    patterns = [pat.load_pattern_yaml(p) for p in args.pattern_files.split(",")]
    # an explicit device: with --show_pattern the detector runs on a worker
    # thread, where nothing may depend on a thread's current device
    det = fdet.FeatureDetector(patterns, device=default_device(args.device))

    image_input = create_image_input(args.inputs)
    n_cam = image_input.num_cameras
    dataset = Dataset(num_cameras=n_cam, image_sizes=[])
    for pi, spec in enumerate(patterns):
        dataset.known_geometries.append(KnownGeometry(
            cell_length_in_meters=spec.square_length_in_meters,
            feature_id_to_position=dict(det.corner_maps[pi])))

    os.makedirs(args.output_directory, exist_ok=True)
    record_dirs = [os.path.join(args.output_directory, f"images_camera{ci}")
                   for ci in range(n_cam)]
    options = LiveCaptureOptions(
        live_detection=not args.no_live_detection,
        record_images=args.record_images,
        record_with_detections_only=not args.record_all_images,
        capture_interval=args.capture_interval,
        max_imagesets=args.max_imagesets,
        visualization_directory=args.output_directory,
    )
    consumer = LiveImageConsumer(dataset, det, options,
                                 record_directories=record_dirs)

    # optional fullscreen on-screen pattern for screen-based calibration
    # (the reference's PatternDisplay, ui/pattern_display.cc).  HighGUI
    # is main-thread-only on macOS and flaky off-main on some Qt builds,
    # so the DISPLAY stays on this thread and the capture loop moves to a
    # worker; a shared Event lets either side end the other (quit key
    # stops capture, capture exhaustion closes the window).
    display = None
    if args.show_pattern:
        from camera_calibration_torch.ui.pattern_display import PatternDisplay

        if not PatternDisplay.available():
            print("[record] --show_pattern: no display available; skipping")
        else:
            display = PatternDisplay(patterns[0])

    with image_input:
        if display is not None:
            import threading

            stop = threading.Event()
            result = {"kept": 0}

            def _capture():
                try:
                    result["kept"] = run_live_capture(
                        image_input, consumer, stop_event=stop)
                finally:
                    stop.set()

            worker = threading.Thread(target=_capture, daemon=True)
            worker.start()
            display.run(stop_event=stop)
            worker.join()
            kept = result["kept"]
        else:
            kept = run_live_capture(image_input, consumer)

    out = os.path.join(args.output_directory, "dataset.bin")
    dataset_bin.save_dataset(out, dataset)
    n_feat = sum(len(f) for s in dataset.imagesets for f in s.features)
    print(f"recorded {kept} imagesets ({n_feat} features, "
          f"{consumer.num_recorded} image sets written) -> {out}")
    return 0


def cmd_report(args):
    import torch

    from camera_calibration_torch.ba.dataset import build_per_camera_tables
    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.io import dataset_bin, state_io
    from camera_calibration_torch.report.calibration_report import (
        create_calibration_report)

    device = default_device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    state, used, fid_map = state_io.load_ba_state(
        args.state_directory, dtype=dtype, device=device)
    dataset = dataset_bin.load_datasets(args.dataset_files)
    data = build_per_camera_tables(dataset, fid_map, image_used=used,
                                   dtype=dtype, device=device)
    metrics = create_calibration_report(
        args.output_directory, state, data,
        num_total_imagesets=len(dataset.imagesets))
    for ci, m in enumerate(metrics):
        print(f"camera {ci}: {m}")
    return 0


def _load_state64(path, device):
    """A saved state in float64 on ``device`` (default: the card)."""
    import torch

    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.io import state_io

    return state_io.load_ba_state(path, dtype=torch.float64,
                                  device=default_device(device))


def _unproject_np(model, px):
    """Unit directions (N, 3) and validity (N,) of NumPy pixels, computed
    on the model's device, as NumPy arrays."""
    import torch

    from camera_calibration_torch.models import protocol

    ref = protocol.model_tensor(model)
    d, v = protocol.unproject(
        model, torch.as_tensor(px, dtype=ref.dtype, device=ref.device))
    return d.cpu().numpy(), v.cpu().numpy()


def cmd_compare(args):
    """Direction comparison of two calibrations (the reference's
    tools/compare_calibrations.cc)."""
    import numpy as np

    state_a, _, _ = _load_state64(args.state_a, args.device)
    state_b, _, _ = _load_state64(args.state_b, args.device)
    for ci, (ma, mb) in enumerate(zip(state_a.intrinsics,
                                      state_b.intrinsics)):
        w, h = ma.width, ma.height
        gx, gy = np.meshgrid(np.linspace(2, w - 3, 80),
                             np.linspace(2, h - 3, 60))
        px = np.stack([gx, gy], -1).reshape(-1, 2)
        da, va = _unproject_np(ma, px)
        db, vb = _unproject_np(mb, px)
        m = va & vb
        ang = np.degrees(np.arccos(np.clip(np.sum(da[m] * db[m], -1), -1, 1)))
        print(f"camera {ci}: direction angle diff deg median "
              f"{np.median(ang):.6f} max {ang.max():.6f}")
    return 0


def _svd_rotation(cov):
    """Kabsch: the rotation ``U S Vᵀ`` nearest to the 3×3 ``cov``, with its
    singular values and the reflection fix ``S``."""
    import numpy as np

    u, dvals, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    return u @ s_mat @ vt, dvals, s_mat


def _umeyama(a, b):
    """(scale, R, t) of the similarity that maps points a onto b (N, 3)."""
    import numpy as np

    n = a.shape[0]
    mu_a, mu_b = a.mean(0), b.mean(0)
    ac, bc = a - mu_a, b - mu_b
    r, dvals, s_mat = _svd_rotation(bc.T @ ac / n)
    scale = float(np.trace(np.diag(dvals) @ s_mat)
                  / max((ac ** 2).sum() / n, 1e-30))
    return scale, r, mu_b - scale * r @ mu_a


def cmd_compare_reconstructions(args):
    """State-vs-state reconstruction comparison (the reference's
    CompareReconstructions, tools/bundle_adjustment.cc:223-396).

    Umeyama-aligns the two states' camera-0 centers with scale, estimates
    the rotation between the two intrinsics from unprojected pixel-grid
    directions, aligns the trajectories at their first image and prints
    the scale, the center errors, the intrinsics rotation and the relative
    endpoint difference; writes ``reconstructions_aligned_at_start.mlp``
    beside the two states when their .obj exports exist."""
    import numpy as np

    from camera_calibration_torch.io.meshlab import (
        MeshLabMeshInfo, write_meshlab_project)
    from camera_calibration_torch.ops.se3 import quat_to_matrix

    def global_tr_images(state):
        # x_cam = R(cam_q_rig) (R(rig_q_global) x + rig_t_global) + cam_t_rig;
        # global_T_image inverts the chain
        rc = quat_to_matrix(state.cam_q_rig[0]).cpu().numpy()
        tc = state.cam_t_rig[0].cpu().numpy()
        rs, ts = [], []
        for r_rig, t in zip(quat_to_matrix(state.rig_q_global).cpu().numpy(),
                            state.rig_t_global.cpu().numpy()):
            r_cg = rc @ r_rig
            t_cg = rc @ t + tc
            rs.append(r_cg.T)
            ts.append(-r_cg.T @ t_cg)
        return np.stack(rs), np.stack(ts)

    state1, _, _ = _load_state64(args.state_a, args.device)
    state2, _, _ = _load_state64(args.state_b, args.device)
    if state1.rig_q_global.shape[0] != state2.rig_q_global.shape[0]:
        print("error: the reconstructions must contain the same images "
              f"({state1.rig_q_global.shape[0]} vs "
              f"{state2.rig_q_global.shape[0]} poses)")
        return 1

    r1, c1 = global_tr_images(state1)
    r2, c2 = global_tr_images(state2)
    scale, r_align, t_align = _umeyama(c1, c2)
    center_err = np.linalg.norm(scale * c1 @ r_align.T + t_align - c2,
                                axis=-1)
    print(f"umeyama scale (state_a -> state_b): {scale:.8f}")
    print(f"pose center error after similarity alignment: median "
          f"{np.median(center_err):.6g} mean {center_err.mean():.6g} "
          f"max {center_err.max():.6g}")
    c1s = scale * c1

    # the intrinsics rotation from unprojected pixel-grid directions
    ma, mb = state1.intrinsics[0], state2.intrinsics[0]
    if ma.width != mb.width or ma.height != mb.height:
        print("error: intrinsics image sizes differ")
        return 1
    step = 10
    gx, gy = np.meshgrid(np.arange(0, ma.width, step) + 0.5,
                         np.arange(0, ma.height, step) + 0.5)
    px = np.stack([gx, gy], -1).reshape(-1, 2)
    da, va = _unproject_np(ma, px)
    db, vb = _unproject_np(mb, px)
    valid = va & vb
    da = da[valid] / np.linalg.norm(da[valid], axis=-1, keepdims=True)
    db = db[valid] / np.linalg.norm(db[valid], axis=-1, keepdims=True)
    # Kabsch: intrinsics1_r_intrinsics2 with da[i] = R db[i]
    r_intr = _svd_rotation(da.T @ db)[0]
    ang = np.degrees(np.arccos(np.clip(0.5 * (np.trace(r_intr) - 1.0),
                                       -1.0, 1.0)))
    resid = np.degrees(np.arccos(np.clip(np.sum(da * (db @ r_intr.T), -1),
                                         -1.0, 1.0)))
    print(f"intrinsics rotation between calibrations: {ang:.6f} deg; "
          f"rotation-aligned direction error: median {np.median(resid):.6f} "
          f"max {resid.max():.6f} deg")

    # aligned at the first image: the endpoint difference relative to the
    # mean trajectory length
    def pose4(r, t):
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = t
        return m

    first1_tr_first2 = (pose4(r1[0], c1s[0]) @ pose4(r_intr, np.zeros(3))
                        @ np.linalg.inv(pose4(r2[0], c2[0])))
    back2_in_1 = first1_tr_first2 @ pose4(r2[-1], c2[-1])
    endpoint_diff = float(np.linalg.norm(back2_in_1[:3, 3] - c1s[-1]))
    traj1 = float(np.linalg.norm(np.diff(c1s, axis=0), axis=-1).sum())
    traj2 = float(np.linalg.norm(np.diff(c2, axis=0), axis=-1).sum())
    rel = endpoint_diff / max(0.5 * (traj1 + traj2), 1e-30)
    print(f"relative endpoint difference: {100.0 * rel:.4f}%")

    dirs = [os.path.abspath(args.state_a), os.path.abspath(args.state_b)]
    objs = [os.path.join(d, name) for d in dirs
            for name in ("points.yaml.obj", "rig_tr_global.yaml.obj")]
    if all(os.path.exists(p) for p in objs):
        g1 = np.eye(4)
        g1[0, 0] = g1[1, 1] = g1[2, 2] = scale
        meshes = [
            MeshLabMeshInfo("SfM cloud 1", objs[0], g1),
            MeshLabMeshInfo("SfM camera poses 1", objs[1], g1),
            MeshLabMeshInfo("SfM cloud 2", objs[2], first1_tr_first2),
            MeshLabMeshInfo("SfM camera poses 2", objs[3], first1_tr_first2),
        ]
        mlp = os.path.join(os.path.commonpath(dirs),
                           "reconstructions_aligned_at_start.mlp")
        write_meshlab_project(mlp, meshes)
        print(f"wrote {mlp}")
    return 0


def cmd_localization_accuracy(args):
    """Monte-Carlo localization accuracy of one calibration against
    another (the reference's tools/localization_accuracy_test.cc)."""
    import numpy as np

    from camera_calibration_torch.init.p3p import ransac_p3p

    state_gt, _, _ = _load_state64(args.gt_state, args.device)
    state_cmp, _, _ = _load_state64(args.compared_state, args.device)
    model_gt = state_gt.intrinsics[args.camera_index]
    model_cmp = state_cmp.intrinsics[args.camera_index]
    rng = np.random.default_rng(args.seed)
    w, h = model_gt.width, model_gt.height
    pos_errors, rot_errors = [], []
    for _ in range(args.trials):
        # 15 random pixels unprojected with the reference model at
        # 1.5-2.5 m (world == the reference camera's frame)
        px = rng.uniform([5, 5], [w - 5, h - 5], (15, 2))
        d_gt, _ = _unproject_np(model_gt, px)
        pts = d_gt * rng.uniform(1.5, 2.5, (15, 1))
        d_cmp, _ = _unproject_np(model_cmp, px)
        out = ransac_p3p(d_cmp, pts, max_iterations=20,
                         seed=int(rng.integers(1 << 31)))
        if out is None:
            continue
        r, t, _ = out
        pos_errors.append(np.linalg.norm(t))
        rot_errors.append(np.degrees(np.arccos(np.clip(
            (np.trace(r) - 1) / 2, -1, 1))))
    pos_errors = np.asarray(pos_errors)
    rot_errors = np.asarray(rot_errors)
    print(f"localization over {len(pos_errors)} trials: position error "
          f"median {np.median(pos_errors):.6f} m, p90 "
          f"{np.percentile(pos_errors, 90):.6f} m; rotation error median "
          f"{np.median(rot_errors):.5f} deg")
    return 0


def cmd_fit_parametric(args):
    """Fit parametric models to a generic calibration, with a residual
    report (``report/fitting_report.py``)."""
    from camera_calibration_torch.report.fitting_report import fit_and_report

    state, _, _ = _load_state64(args.state_directory, args.device)
    fit_and_report(state.intrinsics[args.camera_index],
                   args.output_directory,
                   model_names=tuple(args.models.split(",")),
                   co_estimate_rotation=args.co_estimate_rotation)
    return 0


def legend_images(max_error_px):
    """The three legend images of ``create-legends`` as BGR uint8
    arrays: the error-direction hue wheel (hue = direction, value =
    magnitude, white outside the unit disc), the mean-magnitude colour bar
    (inferno over [0, max_error_px]) and the observation-direction key."""
    import cv2
    import numpy as np

    from camera_calibration_torch.report import raster

    n = 512
    yy, xx = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    r = np.hypot(xx, yy)
    hue = (np.arctan2(yy, xx) + np.pi) / (2 * np.pi)
    rgb = raster.hsv_to_rgb(np.stack([hue, np.ones_like(hue),
                                      np.clip(r, 0, 1)], -1))
    rgb[r > 1] = 1.0
    wheel = raster.rgb_to_bgr8(rgb)

    bar = raster.colormapped(np.tile(np.linspace(0, 1, 512), (48, 1)), 0, 1,
                             "inferno")
    bar = np.vstack([bar, np.full((32, 512, 3), 255, np.uint8)])
    cv2.putText(bar, "0", (2, 72), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0))
    label = f"{max_error_px:g} px (mean |reprojection error|)"
    cv2.putText(bar, label, (200, 72), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                (0, 0, 0))

    key = np.full((80, 512, 3), 255, np.uint8)
    cv2.putText(key, "observation directions:", (4, 28),
                cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 0))
    cv2.putText(key, "r = (x+1)/2   g = (y+1)/2   b = (z+1)/2", (4, 62),
                cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 0))
    return {"legend_error_directions.png": wheel,
            "legend_error_magnitudes.png": bar,
            "legend_observation_directions.png": key}


def cmd_create_legends(args):
    """Legend images of the report visualizations (the reference's
    tools/create_legends.cc)."""
    from camera_calibration_torch.report import raster

    os.makedirs(args.output_directory, exist_ok=True)
    for name, img in legend_images(args.max_error_px).items():
        raster.write_png(os.path.join(args.output_directory, name), img)
    print(f"wrote legends to {args.output_directory}")
    return 0


def cmd_intersect_datasets(args):
    """Keep only the features detected in all datasets within a pixel
    threshold, matched by filename (the reference's
    intersect_datasets.cc)."""
    import numpy as np

    from camera_calibration_torch.io import dataset_bin

    datasets = [dataset_bin.load_dataset(p) for p in args.dataset_files]
    base = datasets[0]

    def key_of(s, i):
        return s.filenames[0] if s.filenames else str(i)

    others_by_name = [{key_of(s, i): s for i, s in enumerate(d.imagesets)}
                      for d in datasets[1:]]
    kept = dropped = 0
    for i, s in enumerate(base.imagesets):
        partners = [m.get(key_of(s, i)) for m in others_by_name]
        for ci in range(base.num_cameras):
            out_feats = []
            for f in s.features[ci]:
                ok = all(
                    p_set is not None and any(
                        g.feature_id == f.feature_id
                        and np.linalg.norm(np.asarray(g.xy)
                                           - np.asarray(f.xy))
                        <= args.threshold
                        for g in p_set.features[ci])
                    for p_set in partners)
                if ok:
                    out_feats.append(f)
                    kept += 1
                else:
                    dropped += 1
            s.features[ci] = out_feats
    dataset_bin.save_dataset(args.output, base)
    print(f"kept {kept}, dropped {dropped}; wrote {args.output}")
    return 0


def cmd_convert_dataset(args):
    """Convert dataset.bin <-> the JSON interchange format (the
    reference's convert_dataset.cc)."""
    import json

    import numpy as np

    from camera_calibration_torch.ba.dataset import (
        Dataset, Imageset, KnownGeometry, PointFeature)
    from camera_calibration_torch.io import dataset_bin

    if args.input.endswith(".bin"):
        ds = dataset_bin.load_dataset(args.input)
        doc = {
            "num_cameras": ds.num_cameras,
            "image_sizes": [list(s) for s in ds.image_sizes],
            "imagesets": [
                {
                    "filename": (s.filenames[0] if s.filenames else ""),
                    "features": [
                        [{"x": float(f.xy[0]), "y": float(f.xy[1]),
                          "id": int(f.feature_id)} for f in cam_feats]
                        for cam_feats in s.features
                    ],
                }
                for s in ds.imagesets
            ],
            "known_geometries": [
                {
                    "cell_length_in_meters": g.cell_length_in_meters,
                    "feature_id_to_position": {
                        str(k): list(v)
                        for k, v in g.feature_id_to_position.items()},
                }
                for g in ds.known_geometries
            ],
        }
        with open(args.output, "w") as f:
            json.dump(doc, f)
    else:
        with open(args.input) as f:
            doc = json.load(f)
        ds = Dataset(
            num_cameras=doc["num_cameras"],
            image_sizes=[tuple(s) for s in doc["image_sizes"]],
            imagesets=[
                Imageset(
                    features=[
                        [PointFeature(xy=np.array([f["x"], f["y"]]),
                                      feature_id=f["id"])
                         for f in cam_feats]
                        for cam_feats in s["features"]
                    ],
                    filenames=[s.get("filename", "")],
                )
                for s in doc["imagesets"]
            ],
            known_geometries=[
                KnownGeometry(
                    cell_length_in_meters=g["cell_length_in_meters"],
                    feature_id_to_position={
                        int(k): tuple(v)
                        for k, v in g["feature_id_to_position"].items()},
                )
                for g in doc["known_geometries"]
            ],
        )
        dataset_bin.save_dataset(args.output, ds)
    print(f"converted {args.input} -> {args.output}")
    return 0


def cmd_stereo_depth(args):
    """Stereo depth on a calibrated two-camera rig (the reference's
    tools/stereo_depth_estimation.cc): plane sweep and slanted PatchMatch
    from the left camera, a cheaper right pass for the LR consistency
    mask, a bilateral filter and the speckle filter; writes a coloured
    .obj cloud and a MeshLab project beside it.  Float32 on the card,
    float64 with ``--device cpu``."""
    import dataclasses

    import numpy as np
    import torch

    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.io import state_io
    from camera_calibration_torch.io.meshlab import export_stereo_project
    from camera_calibration_torch.ops import se3
    from camera_calibration_torch.stereo import patch_match as pms

    device = default_device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    state, _, _ = state_io.load_ba_state(args.state_directory,
                                         device="cpu")
    if len(state.intrinsics) < 2:
        print("stereo-depth needs a 2-camera rig state")
        return 1
    models = [state_io.load_camera_model(
        os.path.join(args.state_directory, f"intrinsics{ci}.yaml"),
        dtype=dtype, device=device) for ci in (0, 1)]
    img_l = _load_gray(args.left_image).astype(np.float64) / 255.0
    img_r = _load_gray(args.right_image).astype(np.float64) / 255.0
    # other_tr_ref = cam1_tr_rig ∘ (cam0_tr_rig)⁻¹  (rig frame = cam0 anchor)
    qi, ti = se3.se3_inverse(state.cam_q_rig[0], state.cam_t_rig[0])
    qr, tr = se3.se3_compose(state.cam_q_rig[1], state.cam_t_rig[1], qi, ti)
    r_rel = se3.quat_to_matrix(qr).numpy()
    t_rel = tr.numpy()
    opts = pms.PatchMatchOptions(
        min_depth=args.min_depth, max_depth=args.max_depth,
        num_levels=args.num_levels, iterations=args.iterations)
    tl = torch.as_tensor(img_l, dtype=dtype, device=device)
    trt = torch.as_tensor(img_r, dtype=dtype, device=device)
    result_l = pms.compute_depth_map(tl, trt, models[0], models[1],
                                     (r_rel, t_rel), opts,
                                     algorithm=args.algorithm)
    # LR consistency: a cheaper second pass from the right camera
    opts_r = dataclasses.replace(opts, iterations=max(2, args.iterations // 2))
    result_r = pms.compute_depth_map(trt, tl, models[1], models[0],
                                     (r_rel.T, -r_rel.T @ t_rel), opts_r,
                                     algorithm=args.algorithm)
    mask = pms.lr_consistency_mask(result_l, result_r, models[0], models[1],
                                   (r_rel, t_rel))
    # post-filter chain: bilateral smoothing + speckle removal
    inv_f = pms.bilateral_filter(result_l["inv_depth"], tl)
    result_l = dict(result_l, inv_depth=inv_f,
                    depth=1.0 / torch.clamp_min(inv_f, 1e-9))
    mask = (mask & torch.isfinite(result_l["cost"])).cpu().numpy()
    mask = pms.connected_component_filter(
        mask, result_l["inv_depth"], min_size=args.min_component_size)
    pms.export_point_cloud(args.output, result_l, mask=mask, colors=img_l)
    # companion MeshLab project referencing the exported cloud
    mlp_path = os.path.splitext(args.output)[0] + ".mlp"
    export_stereo_project(mlp_path, [args.output])
    print(f"wrote {args.output}: {int(mask.sum())} points "
          f"({100.0 * mask.mean():.1f}% consistent); project {mlp_path}")
    return 0


def cmd_export_colmap(args):
    """Export a saved calibration state to a COLMAP text model."""
    from camera_calibration_torch.io import colmap, dataset_bin, state_io

    state, used, fid_map = state_io.load_ba_state(args.state_directory,
                                                  device="cpu")
    dataset = (dataset_bin.load_datasets(args.dataset_files)
               if args.dataset_files else None)
    colmap.export_ba_state(args.output_directory, state, dataset, used,
                           fid_map)
    print(f"wrote COLMAP model to {args.output_directory}")
    return 0


def cmd_refine_colmap(args):
    """Bundle-adjust a COLMAP model (poses, points and parametric
    intrinsics) with the LM solver (the reference's
    tools/bundle_adjustment.cc).  Float32 on the card, float64 with
    ``--device cpu``."""
    import numpy as np
    import torch

    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.ba.dataset import ObservationTable
    from camera_calibration_torch.ba.state import BAState
    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.io import colmap

    device = default_device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    model = colmap.read_model(args.colmap_model, dtype=dtype, device=device)
    cam_ids = sorted(model.cameras.keys())
    cam_index = {cid: i for i, cid in enumerate(cam_ids)}
    pt_ids = sorted(model.points3d.keys())
    pt_index = {pid: i for i, pid in enumerate(pt_ids)}
    pts = np.stack([model.points3d[pid][0] for pid in pt_ids])

    # COLMAP images are independent poses: each image becomes its own
    # imageset with the rig anchored at identity; intrinsics per camera
    rig_q, rig_t = [], []
    ims, cams_col, ptids, pixels = [], [], [], []
    for si, im in enumerate(model.images):
        rig_q.append(np.asarray(im.q, float))
        rig_t.append(np.asarray(im.t, float))
        for (x, y, pid) in im.points2d:
            if pid < 0 or pid not in pt_index:
                continue
            ims.append(si)
            cams_col.append(cam_index[im.camera_id])
            ptids.append(pt_index[pid])
            pixels.append([x, y])
    n_cams = len(cam_ids)
    # camera-major sort
    order = np.lexsort((np.array(ims), np.array(cams_col)))
    ims = np.array(ims, np.int64)[order]
    cams_col = np.array(cams_col, np.int64)[order]
    ptids = np.array(ptids, np.int64)[order]
    pixels = np.array(pixels, float)[order]

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    state = BAState(
        rig_q_global=t(np.stack(rig_q)), rig_t_global=t(np.stack(rig_t)),
        cam_q_rig=t(np.tile([1.0, 0, 0, 0], (n_cams, 1))),
        cam_t_rig=t(np.zeros((n_cams, 3))), points=t(pts),
        intrinsics=tuple(model.cameras[cid] for cid in cam_ids))
    data = []
    for c in range(n_cams):
        m = cams_col == c
        data.append(ObservationTable(
            imageset=t(ims[m], torch.int64), camera=t(cams_col[m], torch.int64),
            point=t(ptids[m], torch.int64), pixel=t(pixels[m]),
            valid=torch.ones(int(m.sum()), dtype=torch.bool, device=device)))
    freeze = {f for f in args.freeze.split(",") if f}
    # COLMAP poses live in rig_tr_global; the per-camera extrinsics are a
    # redundant identity here and stay frozen
    freeze.add("extrinsics")
    options = lm_pcg.BAOptions(
        max_lm_iterations=args.iterations, max_pcg_iterations=60,
        cost_reduction_threshold=1e-7, freeze=tuple(sorted(freeze)))
    state, info = lm_pcg.optimize(state, None, None, options,
                                  data=tuple(data))
    print(f"[refine-colmap] final cost {info['final_cost']}")

    # write back
    rq = state.rig_q_global.cpu().numpy()
    rt = state.rig_t_global.cpu().numpy()
    new_images = [colmap.ColmapImage(
        image_id=im.image_id, q=rq[si], t=rt[si], camera_id=im.camera_id,
        name=im.name, points2d=im.points2d)
        for si, im in enumerate(model.images)]
    pts_out = state.points.cpu().numpy()
    new_pts = {}
    for pid in pt_ids:
        _, rgb, err, track = model.points3d[pid]
        new_pts[pid] = (pts_out[pt_index[pid]], rgb, err, track)
    new_cams = {cid: state.intrinsics[cam_index[cid]] for cid in cam_ids}
    colmap.write_model(args.output_directory, colmap.ColmapModel(
        cameras=new_cams, images=new_images, points3d=new_pts))
    print(f"wrote refined COLMAP model to {args.output_directory}")
    return 0


def _load_obj_vertices(path):
    import numpy as np

    pts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                v = line.split()
                pts.append([float(v[1]), float(v[2]), float(v[3])])
    return np.asarray(pts)


def cmd_compare_point_clouds(args):
    """Similarity-align two point clouds (scaled Umeyama) and print
    distance statistics (the reference's compare_point_clouds.cc), or
    nearest-neighbour distances without correspondences."""
    import numpy as np

    a = _load_obj_vertices(args.cloud_a)
    b = _load_obj_vertices(args.cloud_b)
    n = min(len(a), len(b))
    if args.paired:
        a, b = a[:n], b[:n]
        # Umeyama with scaling: align a -> b
        mu_a, mu_b = a.mean(0), b.mean(0)
        ac, bc = a - mu_a, b - mu_b
        r, dvals, s_mat = _svd_rotation(bc.T @ ac / n)
        c = np.trace(np.diag(dvals) @ s_mat) / ((ac ** 2).sum() / n)
        t = mu_b - c * r @ mu_a
        d = np.linalg.norm(c * a @ r.T + t - b, axis=-1)
        print(f"paired alignment: scale {c:.6f}; distance median "
              f"{np.median(d):.6f} mean {d.mean():.6f} max {d.max():.6f}")
    else:
        from scipy.spatial import cKDTree

        d, _ = cKDTree(b).query(a, k=1)
        print(f"nn distances a->b: median {np.median(d):.6f} mean "
              f"{d.mean():.6f} p90 {np.percentile(d, 90):.6f}")
    return 0


def _kalibr_load_cameras(path, device=None):
    """A Kalibr camchain YAML -> {index: parametric model} in float64 on
    ``device`` (default: the card).

    pinhole + radtan -> OpenCV (k1 k2 p1 p2), pinhole + equidistant ->
    ThinPrismFisheye (k1..k4) with the equidistant pre-step, pinhole
    without distortion -> PinholeCamera.
    """
    import numpy as np
    import torch
    import yaml

    from camera_calibration_torch.config import default_device
    from camera_calibration_torch.models import parametric as pm
    from camera_calibration_torch.models import pinhole as ph

    device = default_device(device)
    with open(path) as f:
        doc = yaml.safe_load(f)
    cams = {}
    for key, spec in doc.items():
        if not key.startswith("cam"):
            continue
        idx = int(key[3:])
        fu, fv, pu, pv = spec["intrinsics"]
        w, h = spec["resolution"]
        dist_model = spec.get("distortion_model", "none")
        coeffs = spec.get("distortion_coeffs", []) or []
        params = np.zeros(12)
        params[:4] = [fu, fv, pu, pv]
        if dist_model == "radtan":
            if len(coeffs) >= 2:
                params[4:6] = coeffs[:2]  # k1 k2
            if len(coeffs) >= 4:
                params[10:12] = coeffs[2:4]  # p1 p2
            cams[idx] = pm.CentralOpenCVModel(
                params=torch.as_tensor(params, device=device),
                width=int(w), height=int(h))
        elif dist_model == "equidistant":
            params[4:4 + min(4, len(coeffs))] = coeffs[:4]
            cams[idx] = pm.CentralThinPrismFisheyeModel(
                params=torch.as_tensor(params, device=device),
                width=int(w), height=int(h), use_equidistant_projection=True)
        else:
            cams[idx] = ph.make_pinhole(fu, fv, pu, pv, int(w), int(h),
                                        device=device)
    return cams


def camera_visualization(model):
    """The arrays of ``visualize-calibration``'s two images of a camera:
    the observation directions as RGB (120, 160, 3) on a pixel lattice,
    and the distortion displacement (120, 160) in pixels from the pinhole
    fitted to the central directions (NaN where invalid; None when fewer
    than 17 directions lie within 0.2 of the axis)."""
    import numpy as np

    w, h = model.width, model.height
    ys = np.linspace(1, h - 2, 120)
    xs = np.linspace(1, w - 2, 160)
    gx, gy = np.meshgrid(xs, ys)
    dirs, valid = _unproject_np(model, np.stack([gx, gy], -1).reshape(-1, 2))
    dirs = dirs.reshape(len(ys), len(xs), 3)
    valid = valid.reshape(len(ys), len(xs))
    rgb = 0.5 * (dirs + 1.0)
    rgb[~valid] = 0.0
    # distortion displacement: |pixel − ideal pinhole projection| with the
    # pinhole fitted to the central region
    z = np.maximum(dirs[..., 2], 1e-9)
    nx = dirs[..., 0] / z
    ny = dirs[..., 1] / z
    center = valid & (np.hypot(nx, ny) < 0.2)
    if center.sum() <= 16:
        return rgb, None
    a = np.zeros((2 * int(center.sum()), 4))
    a[0::2, 0] = nx[center]
    a[0::2, 2] = 1.0
    a[1::2, 1] = ny[center]
    a[1::2, 3] = 1.0
    rhs = np.stack([gx[center], gy[center]], -1).reshape(-1)
    sol, *_ = np.linalg.lstsq(a, rhs, rcond=None)
    disp = np.hypot(sol[0] * nx + sol[2] - gx, sol[1] * ny + sol[3] - gy)
    disp[~valid] = np.nan
    return rgb, disp


def _visualize_camera(model, base_path):
    """Write ``<base>_directions.png`` and ``<base>_distortion.png``
    (viridis over the displacement's range) as rasters."""
    import numpy as np

    from camera_calibration_torch.report import raster

    rgb, disp = camera_visualization(model)
    raster.write_png(base_path + "_directions.png", raster.rgb_to_bgr8(rgb))
    if disp is not None:
        raster.write_png(base_path + "_distortion.png", raster.colormapped(
            disp, np.nanmin(disp), np.nanmax(disp), "viridis"))


def cmd_visualize_calibration(args):
    """Visualize a calibration from a Kalibr camchain YAML, a COLMAP
    model directory or a state directory (the reference's
    tools/visualize_calibration.cc)."""
    os.makedirs(args.output_directory, exist_ok=True)
    if args.kalibr_yaml:
        cams = _kalibr_load_cameras(args.kalibr_yaml, args.device)
        tag = "kalibr"
    elif args.colmap_model:
        from camera_calibration_torch.io import colmap

        model = colmap.read_model(args.colmap_model, device=args.device)
        cams = {cid - 1: c for cid, c in model.cameras.items()}
        tag = "colmap"
    elif args.state_directory:
        state, _, _ = _load_state64(args.state_directory, args.device)
        cams = dict(enumerate(state.intrinsics))
        tag = "state"
    else:
        print("need --kalibr_yaml, --colmap_model, or --state_directory")
        return 1
    for idx, cam in cams.items():
        base = os.path.join(args.output_directory, f"{tag}_camera{idx}")
        _visualize_camera(cam, base)
        print(f"wrote {base}_directions.png")
    return 0


def build_parser():
    parser = argparse.ArgumentParser(
        prog="camera-calibration-torch",
        description="generic camera calibration on an NVIDIA card")
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default=None,
                       help="device to compute on (default: the card)")

    p = sub.add_parser("calibrate", help="full calibration pipeline")
    p.add_argument("--image_directories", help="comma-separated, one per camera")
    p.add_argument("--pattern_files", help="comma-separated pattern YAMLs")
    p.add_argument("--dataset_files", help="existing dataset.bin")
    p.add_argument("--output_directory", required=True)
    p.add_argument(
        "--model", default=None,
        choices=["central_generic", "noncentral_generic",
                 "central_thin_prism_fisheye", "central_opencv",
                 "central_radial"],
        help="camera model (default central_generic for fresh "
             "calibrations; on --state_directory resume, passing this "
             "explicitly resamples/converts the loaded state to the "
             "requested model and resolution and re-runs the pyramid)")
    p.add_argument("--num_pyramid_levels", type=int, default=3)
    p.add_argument("--approx_pixels_per_cell", type=int, default=25)
    p.add_argument("--outlier_removal_factor", type=float, default=8.0)
    p.add_argument("--final_iterations", type=int, default=100)
    p.add_argument(
        "--lm_steps_per_call", type=int, default=1,
        help="LM iterations per call; >1 checkpoints every k-th iteration")
    p.add_argument(
        "--dtype", default="mixed", choices=["mixed", "float32", "float64"],
        help="mixed (default) runs the pipeline in float32 on the device "
             "(the CUDA kernels on the card) and finishes with float64 "
             "polish iterations on the CPU; float64 runs everything in "
             "float64 on --device (the card's kernels take float32 only: "
             "use --device cpu); float32 skips the polish")
    p.add_argument(
        "--polish_iterations", type=int, default=10,
        help="float64 CPU LM iterations after the float32 pipeline (mixed "
             "dtype only)")
    p.add_argument(
        "--solver", default="auto",
        choices=["auto", "schur", "schur_poses", "schur_direct",
                 "schur_direct_points", "pcg"],
        help="BA solver mode: schur/schur_poses = point/pose elimination + "
             "PCG on the reduced system; schur_direct[_points] = explicit "
             "reduced system + dense Cholesky; pcg = full-system PCG")
    p.add_argument(
        "--block_chunk", type=int, default=None,
        help="evaluate residual/Jacobian blocks in chunks of this many "
             "observations to bound memory")
    p.add_argument(
        "--cg_warm_start", action="store_true",
        help="warm-start each PCG solve from the previous LM step (needs "
             "--lm_steps_per_call > 1 and a PCG solver mode)")
    p.add_argument(
        "--proj_iterations", type=int, default=4,
        help="projection LM iterations per blocks sweep (warm-started)")
    p.add_argument("--report", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--state_directory",
        help="resume from a saved state instead of dense initialization")
    p.add_argument(
        "--dense_initialization_base_path",
        help="cache the dense initialization here (.npz): loaded when "
             "present so re-runs skip the init phase, saved after a fresh "
             "init")
    p.add_argument(
        "--localize_only", action="store_true",
        help="freeze intrinsics and pattern points; optimize poses only")
    p.add_argument(
        "--live_directory",
        help="write per-stage visualization PNGs here as calibration "
             "progresses (the headless CalibrationWindow)")
    device_flag(p)
    p.set_defaults(func=cmd_calibrate)

    p = sub.add_parser(
        "record",
        help="live capture from cameras/videos/directories -> dataset.bin")
    p.add_argument(
        "--inputs", required=True,
        help="comma-separated per-camera sources: v4l2:<index>, "
             "video:<path>, or dir:<path>")
    p.add_argument("--pattern_files", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--record_images", action="store_true",
                   help="write captured images to per-camera directories")
    p.add_argument("--record_all_images", action="store_true",
                   help="record imagesets even without detections")
    p.add_argument("--no_live_detection", action="store_true",
                   help="record only; skip per-frame feature detection")
    p.add_argument("--capture_interval", type=float, default=0.0,
                   help="minimum seconds between processed imagesets")
    p.add_argument("--max_imagesets", type=int, default=None)
    p.add_argument("--show_pattern", action="store_true",
                   help="show the pattern fullscreen on the local display "
                        "for screen-based calibration (reference "
                        "ui/pattern_display.cc); skipped when no display "
                        "is available")
    device_flag(p)
    p.set_defaults(func=cmd_record)

    p = sub.add_parser("report", help="report for a saved state")
    p.add_argument("--state_directory", required=True)
    p.add_argument("--dataset_files", required=True)
    p.add_argument("--output_directory", required=True)
    device_flag(p)
    p.set_defaults(func=cmd_report)

    p = sub.add_parser("compare", help="compare two calibrations")
    p.add_argument("state_a")
    p.add_argument("state_b")
    device_flag(p)
    p.set_defaults(func=cmd_compare)

    p = sub.add_parser(
        "compare-reconstructions",
        help="Umeyama-aligned pose + intrinsics comparison of two saved "
             "states (the reference's CompareReconstructions tool)")
    p.add_argument("state_a")
    p.add_argument("state_b")
    device_flag(p)
    p.set_defaults(func=cmd_compare_reconstructions)

    p = sub.add_parser("fit-parametric",
                       help="fit parametric models to a generic calibration")
    p.add_argument("--state_directory", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--camera_index", type=int, default=0)
    p.add_argument("--co_estimate_rotation", action="store_true")
    p.add_argument(
        "--models",
        default="central_thin_prism_fisheye,central_opencv,central_radial")
    device_flag(p)
    p.set_defaults(func=cmd_fit_parametric)

    p = sub.add_parser("create-legends",
                       help="legend images for the report visualizations")
    p.add_argument("--output_directory", required=True)
    p.add_argument("--max_error_px", type=float, default=1.0)
    p.set_defaults(func=cmd_create_legends)

    p = sub.add_parser("intersect-datasets",
                       help="keep features present in all datasets")
    p.add_argument("dataset_files", nargs="+")
    p.add_argument("--output", required=True)
    p.add_argument("--threshold", type=float, default=1.0)
    p.set_defaults(func=cmd_intersect_datasets)

    p = sub.add_parser("convert-dataset", help="dataset.bin <-> JSON")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(func=cmd_convert_dataset)

    p = sub.add_parser(
        "localization-accuracy",
        help="Monte-Carlo localization accuracy of a calibration vs GT")
    p.add_argument("--gt_state", required=True)
    p.add_argument("--compared_state", required=True)
    p.add_argument("--camera_index", type=int, default=0)
    p.add_argument("--trials", type=int, default=10000,
                   help="Monte-Carlo trials (the reference's default)")
    p.add_argument("--seed", type=int, default=0)
    device_flag(p)
    p.set_defaults(func=cmd_localization_accuracy)

    p = sub.add_parser("extract-features", help="detector only")
    p.add_argument("--image_directories", required=True)
    p.add_argument("--pattern_files", required=True)
    p.add_argument("--output", required=True, help="output dataset.bin")
    device_flag(p)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.set_defaults(func=cmd_extract_features)

    p = sub.add_parser("create-pattern", help="generate a star pattern")
    p.add_argument("--output_directory", required=True)
    p.add_argument("--squares_x", type=int, default=17)
    p.add_argument("--squares_y", type=int, default=24)
    p.add_argument("--num_star_segments", type=int, default=16)
    p.add_argument("--square_length_in_meters", type=float, default=0.0118)
    p.add_argument("--apriltags", action="store_true", default=True)
    p.add_argument("--first_tag_index", type=int, default=0)
    p.add_argument("--dpi_pixels_per_square", type=int, default=64)
    p.set_defaults(func=cmd_create_pattern)

    p = sub.add_parser("stereo-depth", help="depth estimation on a stereo rig")
    p.add_argument("--state_directory", required=True)
    p.add_argument("--left_image", required=True)
    p.add_argument("--right_image", required=True)
    p.add_argument("--output", required=True, help="output .obj point cloud")
    p.add_argument("--min_depth", type=float, default=0.2)
    p.add_argument("--max_depth", type=float, default=20.0)
    p.add_argument("--num_levels", type=int, default=96)
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--algorithm", default="patch_match",
                   choices=["patch_match", "plane_sweep"])
    p.add_argument("--min_component_size", type=int, default=50)
    device_flag(p)
    p.set_defaults(func=cmd_stereo_depth)

    p = sub.add_parser("visualize-calibration",
                       help="visualize a Kalibr/COLMAP/state calibration")
    p.add_argument("--kalibr_yaml")
    p.add_argument("--colmap_model")
    p.add_argument("--state_directory")
    p.add_argument("--output_directory", required=True)
    device_flag(p)
    p.set_defaults(func=cmd_visualize_calibration)

    p = sub.add_parser("refine-colmap", help="bundle-adjust a COLMAP model")
    p.add_argument("--colmap_model", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--freeze", default="",
                   help="comma list: poses,points,intrinsics")
    device_flag(p)
    p.set_defaults(func=cmd_refine_colmap)

    p = sub.add_parser("compare-point-clouds",
                       help="align + compare two .obj point clouds")
    p.add_argument("cloud_a")
    p.add_argument("cloud_b")
    p.add_argument("--paired", action="store_true")
    p.set_defaults(func=cmd_compare_point_clouds)

    p = sub.add_parser("export-colmap", help="export state to a COLMAP model")
    p.add_argument("--state_directory", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--dataset_files")
    p.set_defaults(func=cmd_export_colmap)

    p = sub.add_parser("render-synthetic", help="render a synthetic dataset")
    p.add_argument("--pattern_file", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--num_images", type=int, default=20)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--min_z", type=float, default=0.45)
    p.add_argument("--max_z", type=float, default=0.75)
    p.add_argument("--noise", type=float, default=0.01)
    p.add_argument("--vignetting", type=float, default=0.0,
                   help="radial falloff strength (0-1; ~0.35 is a strong "
                        "lens vignette)")
    p.add_argument("--defocus_sigma", type=float, default=0.0,
                   help="Gaussian PSF sigma in pixels")
    p.add_argument("--jpeg_quality", type=int, default=0,
                   help="round-trip through JPEG at this quality "
                        "(1-99; 0 = lossless PNG only)")
    p.add_argument("--exposure_drift", type=float, default=0.0,
                   help="per-frame random gain/offset amplitude "
                        "(e.g. 0.2 = +/-20%% gain)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=cmd_render_synthetic)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
