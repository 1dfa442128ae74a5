"""PyTorch/CUDA port of the camera-calibration engine.

The bundle-adjustment hot path (CentralGeneric spline-grid model, Schur
PCG Levenberg-Marquardt) runs on an NVIDIA Hopper card through hand-written
CUDA kernels (``csrc/``); every kernel has a plain PyTorch version beside it,
which is the only path for tensors on the CPU.
"""

from camera_calibration_torch import config as _config  # noqa: F401

__all__ = []
