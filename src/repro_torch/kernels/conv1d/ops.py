"""Wrapper of the Hopper causal depthwise conv1d kernel (``csrc/conv1d.cu``).

Replaces the Pallas kernel ``repro/kernels/conv1d/kernel.py::_conv_kernel``
(``causal_conv1d_pallas``, behind ``repro/kernels/conv1d/ops.py::
causal_conv1d``). The Pallas wrapper cuts S into 2,048-row pieces for
VMEM and carries the K-1 tail between them; the CUDA kernel reads any S
in one launch, and takes that tail as an input instead of the zero pad,
which is also what a decode or chunk step of the model needs (the
reference's ``ssm._causal_conv`` and ``rglru._conv`` with ``tail=``).

What bounds it on the H100: bytes. A launch reads x, the tail, w and b
once and writes y, ~2 bytes in and out per bf16 element with K=4 FMAs:
a 512-token Mamba-2 prefill layer (C=1,792) moves ~3.7 MB, ~1.1 us at
3.35 TB/s. A decode step (S=1) is latency-bound.

The kernel accumulates in float32, as the Pallas kernel does, where the
reference's model code sums bfloat16 products: in bfloat16 the two differ
by a few ulps, in float32 they agree. On a CPU tensor the wrapper
computes the plain version in ``ref.py``. On a CUDA tensor it launches the
kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_activations
from repro_torch.kernels.conv1d.ref import (
    ACTIVATIONS, causal_conv1d_ref, new_tail,
)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv1d")
    fn = lib.conv1d_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  activation: str = "none",
                  tail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,C), w (K,C), b (C,) in x's dtype, tail (B,K-1,C) in x's
    dtype or None (zeros) -> (y (B,S,C) in x's dtype, new tail (B,K-1,C),
    the last K-1 rows of ``[tail, x]``)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    if x.device.type == "cpu":
        return causal_conv1d_ref(x, w, b, activation=activation, tail=tail)
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d: no kernel for device {x.device}")
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"causal_conv1d: x must be (B,S,C) and w (K,C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, S, C = x.shape
    K = w.shape[0]
    tensors = dict(x=x, w=w, b=b)
    shapes = dict(w=(K, C), b=(C,), tail=(B, K - 1, C))
    if tail is not None:
        tensors["tail"] = tail
    dtype = check_activations("causal_conv1d", tensors, shapes)
    lib = _lib()
    y = torch.empty_like(x)
    rc = lib.conv1d_launch(
        x.data_ptr(), tail.data_ptr() if tail is not None else None,
        w.data_ptr(), b.data_ptr(), y.data_ptr(), B, S, C, K,
        int(activation == "silu"), dtype, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, rc, "causal_conv1d")
    causal_conv1d.launches += 1
    return y, new_tail(x, tail, K)


causal_conv1d.launches = 0  # kernel launches since the count was last reset
