"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is absent:
nothing falls back to the CPU on its own.  The CPU runs only when the
caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, raising when it
    names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def full_float32(dev: torch.device):
    """Stated, not inherited: float32 convolutions and matmuls on the card
    run in full float32 (cuDNN and cuBLAS would otherwise take TF32, whose
    10-bit mantissa moves SegNet's scores by ~1e-3)."""
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
