"""Global numerical configuration and device selection.

Camera calibration needs full float32 matmul accuracy.  TF32 keeps about
three decimal digits of the mantissa, which turns a float32 DLT homography
from ~1e-5 px reprojection error into ~0.1 px; sub-0.1 px calibration is the
whole point of this framework.  PyTorch's float32 matmuls on the card run in
full precision by default, but cuDNN convolutions default to TF32, so both
switches are set here, at import, together with the "highest" float32
matmul precision.
"""

from __future__ import annotations

import torch


def configure_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def default_device(device=None) -> torch.device:
    """The device for tensors that an entry point creates.

    ``None`` means the card: it raises when CUDA is unavailable rather than
    dropping to the CPU.  Callers that want the CPU say so with ``"cpu"``.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


configure_precision()
