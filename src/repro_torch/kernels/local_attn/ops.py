"""Wrapper of the Hopper sliding-window attention kernel
(``csrc/local_attn.cu``).

Replaces the Pallas kernel ``repro/kernels/local_attn/kernel.py::_kernel``
(``local_attention_pallas``, behind ``repro/kernels/local_attn/ops.py::
local_attention_fused``): the whole-prompt attention of a local layer.
GQA reads KV head h // G in the kernel, so no repeated K/V exists. The
Pallas wrapper pads S to a block multiple and masks keys past the true
length; the CUDA kernel bounds-checks instead, so any S runs as it is.

What bounds it on the H100: at recurrentgemma-2b's longest prefill
(S=2,560, window 2,048, 10 query heads on 1 KV head, D=256) the band
holds ~31.5 M query-key pairs, ~32 GFLOP: ~33 us on the bf16 tensor
cores, ~8.6 us of bytes. bf16 inputs go to a kernel whose two products
run on the tensor cores (``mma.sync``, K/V tiles brought by ``cp.async``);
float32 inputs to one on the float32 CUDA cores, exact to float32
tolerances; see the source.

``softcap`` (gemma2's attention softcap, 50) caps each float32 score as
the reference's model code does (``models/attention.py::local_attention``,
which the Pallas kernel does not): ``s = c * tanh(s / c)`` after the
division by sqrt(D) and before the mask. 0 turns it off, and the kernels
then run their instantiations without it.

The host path is kept short, as the other wrappers' are: one test of the
common case before the detailed checks, the raw stream handle, and the
arguments packed into one ctypes argument (the softcap as a float32
field).

The kernels divide the score by sqrt(D), as the Pallas kernel does, and
keep the scores, the softmax state and the accumulator in float32, where
the reference's model code multiplies by the reciprocal and rounds
through the activation dtype: in bfloat16 the two differ by a few ulps,
in float32 they agree to rounding. The bf16 kernel also rounds p to bf16
for the P.V product (the Pallas kernel keeps it in float32), which moves
an output by up to ~2^-9 of its row's largest |v|. On a CPU tensor
the wrapper computes the plain version in ``ref.py``. On a CUDA tensor it
launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    DTYPE_CODES, check_activations, stream_handle,
)
from repro_torch.kernels.local_attn.ref import local_attention_ref

HEAD_DIMS = (64, 128, 256)          # instantiated in csrc/local_attn.cu
# 14 int64 (pointers, shape, window, causal, dtype, device, stream), then
# the softcap
_ARGS = struct.Struct("=14qf")


def _lib() -> ctypes.CDLL:
    lib = build.load("local_attn")
    if lib.local_attn_launch.argtypes is None:
        lib.local_attn_launch.argtypes = [ctypes.c_char_p]
        lib.local_attn_launch.restype = ctypes.c_int
    return lib


def _check(q, k, v, B: int, S: int, Hq: int, Hkv: int, D: int) -> int:
    """Raise unless the inputs are what the kernel takes; return the dtype
    flag of the launch. One test of the common case, then, only where it
    fails, ``check_activations``, which names the fault."""
    dt = q.dtype
    code = DTYPE_CODES.get(dt)
    d = q.get_device()
    if (code is None or k.dtype is not dt or v.dtype is not dt
            or not (q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous())
            or k.get_device() != d or v.get_device() != d
            or k.shape != (B, S, Hkv, D) or v.shape != (B, S, Hkv, D)):
        code = check_activations("local_attention_fused", dict(q=q, k=k, v=v),
                                 dict(k=(B, S, Hkv, D), v=(B, S, Hkv, D)))
    if Hq % Hkv:
        raise ValueError(f"local_attention_fused: Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"local_attention_fused: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    return code


def local_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int, causal: bool = True,
                          softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,Hq,D), k/v (B,S,Hkv,D) of one dtype -> (B,S,Hq,D) in q's
    dtype. Causal: key j is attendable from query i iff 0 <= i - j <
    window; non-causal: iff |i - j| < window. ``softcap`` > 0 caps each
    score at ``softcap * tanh(s / softcap)``; 0 turns it off."""
    if window < 1:
        raise ValueError(f"local_attention_fused: window must be >= 1, got "
                         f"{window}")
    if not (softcap >= 0.0 and math.isfinite(softcap)):
        raise ValueError(f"local_attention_fused: softcap must be finite "
                         f"and >= 0, got {softcap}")
    if not q.is_cuda:
        kind = q.device.type
        if kind == "cpu":
            return local_attention_ref(q, k, v, window=window, causal=causal,
                                       softcap=softcap)
        if kind != "cuda":
            raise ValueError(f"local_attention_fused: no kernel for device "
                             f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"local_attention_fused: q must be (B,S,Hq,D) and "
                         f"k/v (B,S,Hkv,D), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    code = _check(q, k, v, B, S, Hq, Hkv, D)
    lib = _lib()
    out = torch.empty_like(q)
    dev = q.get_device()
    rc = lib.local_attn_launch(_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq,
        Hkv, D, window, causal, code, dev, stream_handle(dev), softcap))
    if rc:
        build.check_launch(lib, rc, "local_attention_fused")
    local_attention_fused.launches += 1
    return out


local_attention_fused.launches = 0  # kernel launches since the count was last reset
