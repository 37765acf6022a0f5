"""Input checks shared by the kernel wrappers: each CUDA kernel takes
contiguous float32 tensors of fixed shapes on one device, and a wrapper
raises on anything else rather than launch on it."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def check_inputs(what: str, tensors: Dict[str, torch.Tensor],
                 shapes: Dict[str, Tuple[int, ...]]) -> None:
    """Raise unless every tensor lies on the first one's device, is float32
    and contiguous, and has the shape ``shapes`` gives for its name."""
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, the rest on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must be {shapes[name]}, "
                             f"got {tuple(t.shape)}")
