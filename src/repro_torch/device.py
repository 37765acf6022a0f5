"""Device selection shared by the port's entry points.

The entry points default to the card. Asking for CUDA where there is none
raises: the CPU is used only when the caller asks for it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; for CUDA, check that a card is
    there and keep float32 products in full float32 (no TF32)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def as_f32(v: Any, device: torch.device) -> torch.Tensor:
    """An array or tensor as a contiguous float32 tensor on ``device``."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=torch.float32).contiguous()
