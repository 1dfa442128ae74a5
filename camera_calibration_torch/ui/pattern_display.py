"""On-screen calibration pattern display (interactive capture aid).

The reference shows the pattern fullscreen on a monitor so a camera can
be calibrated by pointing it at the screen, with space-to-capture
(reference: applications/camera_calibration/src/camera_calibration/ui/
pattern_display.cc).  This is the headless framework's equivalent built
on OpenCV's HighGUI: available whenever a display server exists, cleanly
reporting unavailability otherwise (CI and headless machines, where
OpenCV's headless build has ``namedWindow`` but raises on use: the
environment check comes first).

Keys: SPACE capture-tick (caller-provided callback), q/ESC quit.
"""

from __future__ import annotations

import numpy as np


class PatternDisplay:
    """Fullscreen pattern window with a capture callback.

    spec: features.pattern.PatternSpec; on_capture: optional callable
    invoked on SPACE (e.g. to trigger a rig grab in live capture).
    """

    WINDOW = "camera-calibration-torch pattern"

    def __init__(self, spec, screen_size=(1920, 1080), supersample: int = 2):
        from camera_calibration_torch.features import pattern as pat

        self.spec = spec
        w, h = screen_size
        # Fit the whole pattern (plus a half-cell margin) on the screen:
        # homography = pure scale + centering from pattern feature coords
        # to screen pixels.
        px_per_cell = min(
            w / (spec.squares_x + 1.0), h / (spec.squares_y + 1.0)
        )
        off_x = 0.5 * (w - px_per_cell * (spec.squares_x - 2.0))
        off_y = 0.5 * (h - px_per_cell * (spec.squares_y - 2.0))
        h_pat2px = np.array(
            [
                [px_per_cell, 0.0, off_x],
                [0.0, px_per_cell, off_y],
                [0.0, 0.0, 1.0],
            ]
        )
        self.image = pat.render_pattern(
            spec,
            np.linalg.inv(h_pat2px),
            (w, h),
            supersample=supersample,
            tag_renderer=pat.make_tag_renderer(spec) if spec.tags else None,
        )
        self._img8 = (np.clip(self.image, 0.0, 1.0) * 255).astype(np.uint8)

    @staticmethod
    def available() -> bool:
        """True when an interactive HighGUI window can be created."""
        import os

        if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
            return False
        try:
            import cv2  # noqa: F401

            return hasattr(cv2, "namedWindow")
        except Exception:
            return False

    def run(self, on_capture=None, max_captures=None, stop_event=None):
        """Show fullscreen; SPACE fires on_capture, q/ESC exits.

        MUST run on the main thread: OpenCV HighGUI is main-thread-only
        on macOS and unreliable off-main on some Qt builds, so callers
        that also drive a capture loop put the *capture* on a worker
        thread (cli.cmd_record does).  ``stop_event``: a threading.Event;
        the loop exits when it is set (capture finished) and sets it on
        exit (quit key pressed) so the two loops shut each other down.

        Returns the number of captures taken.
        """
        import cv2

        cv2.namedWindow(self.WINDOW, cv2.WINDOW_NORMAL)
        cv2.setWindowProperty(
            self.WINDOW, cv2.WND_PROP_FULLSCREEN, cv2.WINDOW_FULLSCREEN
        )
        captures = 0
        try:
            while True:
                if stop_event is not None and stop_event.is_set():
                    break
                cv2.imshow(self.WINDOW, self._img8)
                key = cv2.waitKey(30) & 0xFF
                if key in (ord("q"), 27):
                    break
                if key == ord(" "):
                    if on_capture is not None:
                        on_capture()
                    captures += 1
                    if max_captures is not None and captures >= max_captures:
                        break
        finally:
            if stop_event is not None:
                stop_event.set()
            cv2.destroyWindow(self.WINDOW)
        return captures
