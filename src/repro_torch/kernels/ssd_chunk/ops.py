"""Wrapper of the Hopper SSD intra-chunk kernel (``csrc/ssd_chunk.cu``).

Replaces the Pallas kernel ``repro/kernels/ssd_chunk/kernel.py::_ssd_kernel``
(``ssd_chunk_pallas``, behind ``repro/kernels/ssd_chunk/ops.py::
ssd_chunk_fused``) with the same signature: head-expanded ``Cc/Bc``
(B,nc,Q,H,N), ``xdt`` (B,nc,Q,H,P), ``dA_cs`` (B,nc,H,Q) in, ``(y_diag,
states)`` out. The kernel reads that strided layout directly, where the
Pallas wrapper transposes to (B*nc, H, Q, ...) first, and builds the
decay mask itself, so the model needs no ``_segsum`` on this path. Any
chunk length Q >= 1 is taken (``ssd_chunked`` uses Q = min(chunk, S)).

What bounds it on the H100: at a 512-token Mamba-2 prefill (nc=2, Q=256,
H=24, N=128, P=64) the function moves ~11 MB and does ~0.8 GFLOP over
its causal pairs, ~3.3 us at 3.35 TB/s; the kernel does its products on
the float32 CUDA cores, so its arithmetic alone needs ~12 us at 67
TFLOP/s. Tensor cores are later work.

The kernel computes in float32, as the Pallas kernel does, where the
reference's model code rounds through the activation dtype: in bfloat16
the two differ by a few ulps, in float32 they agree. On a CPU tensor the
wrapper computes the plain version in ``ref.py``. On a CUDA tensor it
launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_activations
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_N, MAX_P = 256, 64      # state width and head width the kernel takes


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    fn = lib.ssd_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I] * 7 + [_P]
        fn.restype = _I
    return lib


def ssd_chunk_fused(Cc: torch.Tensor, Bc: torch.Tensor, xdt: torch.Tensor,
                    dA_cs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cc/Bc (B,nc,Q,H,N), xdt (B,nc,Q,H,P) of one dtype, dA_cs (B,nc,H,Q)
    float32 -> (y_diag (B,nc,Q,H,P) in xdt's dtype, states (B,nc,H,P,N)
    float32)."""
    if Cc.device.type == "cpu":
        return ssd_chunk_ref(Cc, Bc, xdt, dA_cs)
    if Cc.device.type != "cuda":
        raise ValueError(f"ssd_chunk_fused: no kernel for device {Cc.device}")
    if Cc.dim() != 5 or xdt.dim() != 5:
        raise ValueError(f"ssd_chunk_fused: Cc must be (B,nc,Q,H,N) and xdt "
                         f"(B,nc,Q,H,P), got {tuple(Cc.shape)} and "
                         f"{tuple(xdt.shape)}")
    B, nc, Q, H, N = Cc.shape
    P = xdt.shape[-1]
    dtype = check_activations(
        "ssd_chunk_fused", dict(xdt=xdt, Cc=Cc, Bc=Bc, dA_cs=dA_cs),
        dict(Cc=(B, nc, Q, H, N), Bc=(B, nc, Q, H, N), xdt=(B, nc, Q, H, P),
             dA_cs=(B, nc, H, Q)), fp32=("dA_cs",))
    if N > MAX_N or P > MAX_P:
        raise ValueError(f"ssd_chunk_fused: N={N} or P={P} above the "
                         f"kernel's {MAX_N} and {MAX_P}")
    lib = _lib()
    y = torch.empty_like(xdt)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32,
                         device=xdt.device)
    rc = lib.ssd_chunk_launch(
        Cc.data_ptr(), Bc.data_ptr(), xdt.data_ptr(), dA_cs.data_ptr(),
        y.data_ptr(), states.data_ptr(), B * nc, Q, H, N, P, dtype,
        xdt.device.index, torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check_launch(lib, rc, "ssd_chunk_fused")
    ssd_chunk_fused.launches += 1
    return y, states


ssd_chunk_fused.launches = 0  # kernel launches since the count was last reset
