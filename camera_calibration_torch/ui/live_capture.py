"""Live image capture: detection, recording, and coverage feedback.

Headless re-design of the reference's live mode (reference:
applications/camera_calibration/src/camera_calibration/ui/
live_image_consumer.cc:66-150 LiveImageConsumer::NewImageset and
main.cc:487-600 live-capture bootstrap): each incoming imageset is run
through the feature detector, imagesets with detections are appended to
the growing Dataset, images are optionally recorded to per-camera
directories, and a per-pixel detection-coverage map is maintained so the
operator can see which image regions still lack observations (the
reference's detections-per-pixel visualization,
live_image_consumer.cc:103-150).  Instead of Qt windows, feedback is
written as PNG files and a console line per imageset.

Detection runs on the detector's device (``FeatureDetector(...,
device=...)``: the card unless the caller asks for the CPU), one frame at
a time through ``FeatureDetector.detect``; everything else here is NumPy
on the host.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np


@dataclasses.dataclass
class LiveCaptureOptions:
    live_detection: bool = True
    record_images: bool = False
    # only write image files for imagesets that produced detections
    # (reference: --record_images_with_detections_only)
    record_with_detections_only: bool = True
    # seconds between processed imagesets (0 = every frame); the headless
    # stand-in for the reference's space-to-capture GUI interaction
    capture_interval: float = 0.0
    max_imagesets: int | None = None
    # where coverage maps / overlays are written (None = no visualization)
    visualization_directory: str | None = None


class LiveImageConsumer:
    """Consumes imagesets: detect -> accumulate dataset -> record.

    dataset: ba.dataset.Dataset sized for the rig (num_cameras set);
    detector: features.detector.FeatureDetector or None.
    record_directories: per-camera output directories (created lazily).

    ``detect_seconds`` and ``imageset_seconds`` add up the host time of
    the detector calls and of whole ``new_imageset`` calls.
    """

    def __init__(self, dataset, detector, options: LiveCaptureOptions,
                 record_directories=None, log=print):
        from camera_calibration_torch.ba.dataset import Imageset

        self._imageset_cls = Imageset
        self.dataset = dataset
        self.detector = detector
        self.options = options
        self.record_directories = record_directories
        self.log = log
        self.detections_per_pixel = [None] * dataset.num_cameras
        self.num_processed = 0
        self.num_recorded = 0
        self.detect_seconds = 0.0
        self.imageset_seconds = 0.0

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _to_gray(image):
        if image.ndim == 3:
            import cv2

            return cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        return image

    def _update_coverage(self, camera_index, image_shape, features):
        cov = self.detections_per_pixel[camera_index]
        if cov is None:
            cov = np.zeros(image_shape[:2], np.uint16)
            self.detections_per_pixel[camera_index] = cov
        if not features:
            return
        xy = np.array([f.xy for f in features])
        # mark a window around each feature as covered, as the reference
        # splats a disc per detection (live_image_consumer.cc:118-140)
        r = max(4, min(image_shape[:2]) // 64)
        xs = np.clip(xy[:, 0].astype(int), 0, image_shape[1] - 1)
        ys = np.clip(xy[:, 1].astype(int), 0, image_shape[0] - 1)
        for x, y in zip(xs, ys):
            cov[max(0, y - r):y + r, max(0, x - r):x + r] += 1

    def _record(self, images, index):
        import cv2

        for ci, img in enumerate(images):
            d = self.record_directories[ci]
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(os.path.join(d, f"image{index:05d}.png"), img)
        self.num_recorded += 1

    def write_coverage_maps(self):
        """Write the per-camera detection-coverage PNGs; returns paths."""
        out = []
        vdir = self.options.visualization_directory
        if vdir is None:
            return out
        import cv2

        os.makedirs(vdir, exist_ok=True)
        for ci, cov in enumerate(self.detections_per_pixel):
            if cov is None:
                continue
            vis = np.clip(cov.astype(np.float32) / 4.0, 0.0, 1.0)
            img = (vis * 255).astype(np.uint8)
            path = os.path.join(vdir, f"coverage_camera{ci}.png")
            cv2.imwrite(path, cv2.applyColorMap(img, cv2.COLORMAP_VIRIDIS))
            out.append(path)
        return out

    # -- the consumer entry point -----------------------------------------

    def new_imageset(self, images, filenames=None):
        """Process one synchronized rig imageset (reference:
        LiveImageConsumer::NewImageset).  Returns True if the imageset
        carried detections and was kept."""
        t_start = time.perf_counter()
        feats_per_cam = []
        have_features = False
        for ci, img in enumerate(images):
            if len(self.dataset.image_sizes) <= ci:
                self.dataset.image_sizes.append((img.shape[1], img.shape[0]))
            if self.detector is not None and self.options.live_detection:
                t0 = time.perf_counter()
                features, _ = self.detector.detect(self._to_gray(img))
                self.detect_seconds += time.perf_counter() - t0
            else:
                features = []
            have_features |= bool(features)
            feats_per_cam.append(features)
            self._update_coverage(ci, img.shape, features)

        index = self.num_processed
        self.num_processed += 1

        record = self.options.record_images and (
            have_features or not self.options.record_with_detections_only
        )
        names = filenames
        if record and self.record_directories:
            self._record(images, index)
            names = [f"image{index:05d}.png"] * len(images)

        kept = have_features or not self.options.live_detection
        if kept:
            # empty imagesets are dropped, as the reference deletes the
            # imageset again when no camera detected anything
            # (live_image_consumer.cc:95-98)
            self.dataset.imagesets.append(
                self._imageset_cls(features=feats_per_cam, filenames=names)
            )
            self.log(
                f"[live] imageset {index}: "
                + ", ".join(
                    f"cam{ci}:{len(f)}" for ci, f in enumerate(feats_per_cam)
                )
                + (" (recorded)" if record else "")
            )
        else:
            self.log(f"[live] imageset {index}: no detections (dropped)")
        self.imageset_seconds += time.perf_counter() - t_start
        return kept


def run_live_capture(image_input, consumer: LiveImageConsumer,
                     stop_event=None):
    """Drive an ImageInput through the consumer until it is exhausted,
    options.max_imagesets is reached, or ``stop_event`` (a
    threading.Event, e.g. the on-screen pattern display's quit key) is
    set.  Returns the number of kept imagesets."""
    opts = consumer.options
    kept = 0
    last = 0.0
    for images in image_input:
        if stop_event is not None and stop_event.is_set():
            break
        now = time.monotonic()
        if opts.capture_interval > 0 and (now - last) < opts.capture_interval:
            continue
        last = now
        if consumer.new_imageset(images):
            kept += 1
        if opts.max_imagesets is not None and kept >= opts.max_imagesets:
            break
    consumer.write_coverage_maps()
    return kept
