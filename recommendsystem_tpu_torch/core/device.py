"""Device set-up shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (there is no silent move to the CPU: pass ``device="cpu"``).

    On CUDA this also turns TF32 off for matrix products and cuDNN: TF32
    keeps about three decimal digits, and parity with the float32 reference
    needs full float32 products."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} asked for, but CUDA is not available; "
                f"pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
