"""Command-line interface of the port: the image-side subcommands.

The counterpart of the reference package's ``cli.py`` for the subcommands
whose modules are ported:

  create-pattern    generate a star pattern (YAML, vector PDF, PNG preview)
  render-synthetic  render seeded views of a pattern from a pinhole camera
  extract-features  detector only: image directories -> dataset.bin

The flags are the reference package's.  ``extract-features`` also takes
``--device`` (default: the card; raises without one) and ``--dtype``
(default float32) for the detector's images and refinement.

    python -m camera_calibration_torch.cli create-pattern --output_directory out
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


def detect_dataset(image_dirs, pattern_files, device=None, dtype=None):
    """Run the feature detector over image directories (one per camera,
    the i-th image of each forming imageset i) -> Dataset."""
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


def cmd_render_synthetic(args):
    """Render a synthetic dataset of pattern views from a pinhole camera
    (the reference's tools/render_synthetic_dataset.cc)."""
    import cv2
    import numpy as np

    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.features.degrade import degrade

    spec = pat.load_pattern_yaml(args.pattern_file)
    w, h = args.width, args.height
    os.makedirs(args.output_directory, exist_ok=True)
    renderer = pat.make_tag_renderer(spec) if spec.tags else None
    for i, h_pp, rng in render_views(spec, args.num_images, w, h, args.min_z,
                                     args.max_z, args.seed):
        img = pat.render_pattern(spec, np.linalg.inv(h_pp), (w, h),
                                 supersample=3, tag_renderer=renderer)
        img = degrade(img, rng, vignetting=args.vignetting,
                      defocus_sigma=args.defocus_sigma,
                      jpeg_quality=args.jpeg_quality,
                      exposure_drift=args.exposure_drift, noise=args.noise)
        cv2.imwrite(
            os.path.join(args.output_directory, f"synthetic_{i:04d}.png"),
            (img * 255).astype(np.uint8),
        )
    print(f"rendered {args.num_images} images to {args.output_directory}")
    return 0


def build_parser():
    parser = argparse.ArgumentParser(prog="camera-calibration-torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("extract-features", help="detector only")
    p.add_argument("--image_directories", required=True)
    p.add_argument("--pattern_files", required=True)
    p.add_argument("--output", required=True, help="output dataset.bin")
    p.add_argument("--device", default=None,
                   help="device of the detector's images and refinement "
                        "(default: the card)")
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
