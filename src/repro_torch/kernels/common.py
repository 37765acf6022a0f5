"""Input checks shared by the kernel wrappers: each CUDA kernel takes
contiguous tensors of fixed shapes and dtypes on one device, and a wrapper
raises on anything else rather than launch on it. Also the current
stream's handle, which every launch needs, and the SM count the launch
plans are sized by."""
from __future__ import annotations

import functools
from typing import Dict, Iterable, Tuple

import torch

# dtype codes of the kernels that take either activation dtype
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _current_stream_handle(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# stream_handle(index): the cudaStream_t of PyTorch's current stream on CUDA
# device ``index``, as an int (the capture stream inside a CUDA-graph
# capture). PyTorch's raw accessor, where it has one, skips building a
# Stream object: ~0.1 us of host time on the H100's host against ~4.7 us.
stream_handle = getattr(torch._C, "_cuda_getCurrentRawStream",
                        _current_stream_handle)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_inputs(what: str, tensors: Dict[str, torch.Tensor],
                 shapes: Dict[str, Tuple[int, ...]]) -> None:
    """Raise unless every tensor lies on the first one's device, is float32
    and contiguous, and has the shape ``shapes`` gives for its name."""
    check_activations(what, tensors, shapes, fp32=tensors)


def check_activations(what: str, tensors: Dict[str, torch.Tensor],
                      shapes: Dict[str, Tuple[int, ...]], *,
                      fp32: Iterable[str] = ()) -> int:
    """Raise unless every tensor lies on the first one's device, is
    contiguous, has the shape ``shapes`` gives for its name, and has the
    first tensor's dtype (float32 or bfloat16), or float32 where its name
    is in ``fp32``. Returns the first tensor's dtype code."""
    first = next(iter(tensors.values()))
    fp32 = set(fp32)
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{what}: {name} on {t.device}, the rest on "
                             f"{first.device}")
        want = (torch.float32,) if name in fp32 else tuple(DTYPE_CODES)
        if t.dtype not in want or (name not in fp32 and t.dtype != first.dtype):
            kinds = "float32" if name in fp32 else \
                f"float32 or bfloat16, as {next(iter(tensors))}"
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes "
                            f"{kinds}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must be {shapes[name]}, "
                             f"got {tuple(t.shape)}")
    return DTYPE_CODES.get(first.dtype, 0)
