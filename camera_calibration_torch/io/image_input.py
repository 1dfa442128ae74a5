"""Image input backends: cameras and image sources for live capture.

The port's own copy of the reference package's ``io/image_input.py``
(NumPy and OpenCV; no device work happens here).  Re-designed from the
reference's image-input layer (reference: applications/camera_calibration/
src/camera_calibration/image_input/image_input.h:70
``ImageInput::CreateForInputs`` with v4l2 / RealSense / Structure backends)
for a headless pipeline:

- an ``ImageInput`` yields *imagesets* — one synchronized frame per
  camera of the rig — as grayscale-or-BGR NumPy arrays;
- backends are addressed by spec strings, one per rig camera:
    ``v4l2:<index>``   live camera via OpenCV VideoCapture (the v4l2
                       backend on Linux — the reference's primary input,
                       image_input_v4l2.cc);
    ``video:<path>``   frames of a video file (recorded captures, tests);
    ``dir:<path>``     images of a directory in sorted order (also
                       accepts a bare directory path);
- vendor-SDK depth cameras (librealsense2 / Structure) are out of scope;
  their RGB streams are covered by the v4l2 path.

Consumers iterate ``for images in image_input: ...`` and call ``close()``
(or use it as a context manager).
"""

from __future__ import annotations

import dataclasses
import glob
import os


@dataclasses.dataclass
class AvailableInput:
    """A discovered input (reference: image_input.h:43 AvailableInput)."""

    display_text: str
    type: str  # "v4l2" | "video" | "dir"
    spec: str


def list_v4l2_devices(max_index: int = 8):
    """Enumerate /dev/video* capture devices (reference lists v4l2
    devices in its settings window, image_input_v4l2.cc)."""
    found = []
    for idx in range(max_index):
        if os.path.exists(f"/dev/video{idx}"):
            found.append(
                AvailableInput(
                    display_text=f"V4L2: /dev/video{idx}",
                    type="v4l2",
                    spec=f"v4l2:{idx}",
                )
            )
    return found


class ImageInput:
    """Base: iterate imagesets (lists of per-camera HxW[x3] uint8 arrays)."""

    num_cameras: int = 1

    def __iter__(self):
        return self

    def __next__(self):
        images = self.read()
        if images is None:
            raise StopIteration
        return images

    def read(self):  # pragma: no cover - interface
        raise NotImplementedError

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _CaptureInput(ImageInput):
    """Synchronized OpenCV VideoCapture sources (v4l2 devices or videos).

    grab() is issued on every source before any retrieve() so rig frames
    are as close to simultaneous as the capture backend allows — the role
    of the reference's per-imageset synchronized polling
    (image_input_v4l2.cc).
    """

    def __init__(self, sources):
        import cv2

        self._caps = []
        for src in sources:
            cap = cv2.VideoCapture(src)
            if not cap.isOpened():
                for c in self._caps:
                    c.release()
                raise RuntimeError(f"cannot open capture source {src!r}")
            self._caps.append(cap)
        self.num_cameras = len(self._caps)

    def read(self):
        for cap in self._caps:
            if not cap.grab():
                return None
        images = []
        for cap in self._caps:
            ok, frame = cap.retrieve()
            if not ok:
                return None
            images.append(frame)
        return images

    def close(self):
        for cap in self._caps:
            cap.release()
        self._caps = []


class DirectoryInput(ImageInput):
    """Images from per-camera directories, in sorted filename order."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".pgm", ".tif", ".tiff")

    def __init__(self, directories):
        import cv2

        self._cv2 = cv2
        self._files = []
        for d in directories:
            files = sorted(
                f
                for f in glob.glob(os.path.join(d, "*"))
                if f.lower().endswith(self.EXTS)
            )
            if not files:
                raise RuntimeError(f"no images in directory {d!r}")
            self._files.append(files)
        self.num_cameras = len(self._files)
        self._pos = 0
        self._count = min(len(f) for f in self._files)

    def read(self):
        if self._pos >= self._count:
            return None
        images = []
        for files in self._files:
            img = self._cv2.imread(files[self._pos])
            if img is None:
                raise RuntimeError(f"cannot read image {files[self._pos]!r}")
            images.append(img)
        self._pos += 1
        return images


def _parse_spec(spec: str):
    for prefix in ("v4l2", "video", "dir"):
        if spec.startswith(prefix + ":"):
            return prefix, spec[len(prefix) + 1:]
    if os.path.isdir(spec):
        return "dir", spec
    return "video", spec


def create_image_input(specs) -> ImageInput:
    """Factory over backend spec strings, one per rig camera
    (reference: image_input.h:70 CreateForInputs).

    All cameras of a rig must use the same backend family (capture-like
    v4l2/video sources can mix; directories cannot mix with captures).
    """
    if isinstance(specs, str):
        specs = specs.split(",")
    parsed = [_parse_spec(s.strip()) for s in specs]
    kinds = {k for k, _ in parsed}
    if kinds <= {"v4l2", "video"}:
        sources = [
            int(arg) if kind == "v4l2" else arg for kind, arg in parsed
        ]
        return _CaptureInput(sources)
    if kinds == {"dir"}:
        return DirectoryInput([arg for _, arg in parsed])
    raise ValueError(
        f"cannot mix directory and capture inputs in one rig: {specs}"
    )
