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

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_activations
from repro_torch.kernels.local_attn.ref import local_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (64, 128, 256)          # instantiated in csrc/local_attn.cu


def _lib() -> ctypes.CDLL:
    lib = build.load("local_attn")
    fn = lib.local_attn_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 9 + [_P]
        fn.restype = _I
    return lib


def local_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int, causal: bool = True) -> torch.Tensor:
    """q (B,S,Hq,D), k/v (B,S,Hkv,D) of one dtype -> (B,S,Hq,D) in q's
    dtype. Causal: key j is attendable from query i iff 0 <= i - j <
    window; non-causal: iff |i - j| < window."""
    if window < 1:
        raise ValueError(f"local_attention_fused: window must be >= 1, got "
                         f"{window}")
    if q.device.type == "cpu":
        return local_attention_ref(q, k, v, window=window, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"local_attention_fused: no kernel for device "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"local_attention_fused: q must be (B,S,Hq,D) and "
                         f"k/v (B,S,Hkv,D), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    dtype = check_activations("local_attention_fused", dict(q=q, k=k, v=v),
                              dict(k=(B, S, Hkv, D), v=(B, S, Hkv, D)))
    if Hq % Hkv:
        raise ValueError(f"local_attention_fused: Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"local_attention_fused: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    lib = _lib()
    out = torch.empty_like(q)
    rc = lib.local_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq,
        Hkv, D, int(window), int(bool(causal)), dtype, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, rc, "local_attention_fused")
    local_attention_fused.launches += 1
    return out


local_attention_fused.launches = 0  # kernel launches since the count was last reset
