"""Wrapper of the Hopper Pix-Con gating kernel (``csrc/pixcon.cu``).

Replaces the Pallas kernel ``repro/kernels/pixcon/kernel.py::_pixcon_kernel``
(``pixcon_gate_pallas``, behind ``repro/kernels/pixcon/ops.py::pixcon_gate``).
It takes a leading replica axis on the weights, which is how the
reference's ``jax.vmap`` over watersheds batches the ``pallas_call``, and
it returns the gate weights ``w`` beside the gated input, because the
partitioner ranks pixels by them.

What bounds it on the H100: at the forecast's shapes one launch moves
about 0.4 MB and does about 0.6 MFLOP, far less than one launch's
latency, so it is launch-bound. The design spends one block per
(replica, example) row and keeps ``w`` in shared memory between the MLP,
the normalising sum and the gated write; see the source for the rest.

On a CPU tensor the wrapper computes the plain version in ``ref.py``. On
a CUDA tensor it launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_inputs
from repro_torch.kernels.pixcon.ref import pixcon_gate_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_PIXELS = 8192            # w (P floats) sits in 48 KB of shared memory


def _lib() -> ctypes.CDLL:
    lib = build.load("pixcon")
    fn = lib.pixcon_gate_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return lib


def pixcon_gate(x: torch.Tensor, feats: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                temperature: float = 1.0, normalize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Pix-Con gate. x (R,B,T,P), feats (R,B,P,F), w1 (R,F,Hp),
    b1 (R,Hp), w2 (R,Hp), b2 (R,1) -> (gated x (R,B,T,P), w (R,B,P))."""
    if x.device.type == "cpu":
        return pixcon_gate_ref(x, feats, w1, b1, w2, b2,
                               temperature=temperature, normalize=normalize)
    if x.device.type != "cuda":
        raise ValueError(f"pixcon_gate: no kernel for device {x.device}")
    if x.dim() != 4 or w1.dim() != 3:
        raise ValueError(f"pixcon_gate: x must be (R,B,T,P) and w1 (R,F,Hp), "
                         f"got {tuple(x.shape)} and {tuple(w1.shape)}")
    R, B, T, P = x.shape
    F, Hp = w1.shape[-2:]
    check_inputs("pixcon_gate",
                 dict(x=x, feats=feats, w1=w1, b1=b1, w2=w2, b2=b2),
                 dict(feats=(R, B, P, F), w1=(R, F, Hp), b1=(R, Hp),
                      w2=(R, Hp), b2=(R, 1)))
    if P > MAX_PIXELS:
        raise ValueError(f"pixcon_gate: P={P} exceeds {MAX_PIXELS}")
    out = torch.empty_like(x)
    w = torch.empty((R, B, P), device=x.device, dtype=torch.float32)
    lib = _lib()
    rc = lib.pixcon_gate_launch(
        x.data_ptr(), feats.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), w.data_ptr(),
        R, B, T, P, F, Hp, 1.0 / temperature, int(normalize),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, rc, "pixcon_gate")
    pixcon_gate.launches += 1
    return out, w


pixcon_gate.launches = 0     # kernel launches since the count was last reset
