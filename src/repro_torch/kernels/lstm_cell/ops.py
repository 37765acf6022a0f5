"""Wrapper of the Hopper fused LSTM-step kernel (``csrc/lstm_cell.cu``),
plus the layout adapter from the packed ``(D, 4H)`` gate layout.

Replaces the Pallas kernel
``repro/kernels/lstm_cell/kernel.py::_lstm_kernel`` (``lstm_cell_pallas``,
behind ``repro/kernels/lstm_cell/ops.py::lstm_cell_fused``), with
per-replica weights: the reference's ``jax.vmap`` over watersheds written
out as a leading axis R.

What bounds it on the H100: every launch reads all replicas' weights
once, 4.5 MB (layer 0) and 3.0 MB (layer 1) at the forecast's shapes,
about 1.3 us and 0.9 us at 3.35 TB/s (they can sit in the 50 MB L2), but
with only R*B = 23 rows a launch is latency-bound. The design runs one
thread per (replica, example, hidden unit), reading the weights coalesced
along the hidden unit; see the source. That leaves 46 warps on 132 SMs,
each thread walking 4*(D+H) weight loads in turn: on an H100 a launch
takes about 40 us at the forecast's shape (``chip_smoke.py``), most of the
forecast's device time. Splitting each gate dot over a warp, or keeping
the weights resident over the 30 steps, is the next step for speed.

On a CPU tensor the wrapper computes the plain version in ``ref.py``. On
a CUDA tensor it launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_inputs
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_SMEM_FLOATS = 12 * 1024  # x and h rows staged in 48 KB of smem


def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_cell")
    fn = lib.lstm_cell_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 5 + [_P]
        fn.restype = _I
    return lib


def lstm_cell_fused(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LSTM step. x (R,B,D), h/c (R,B,H), wx (R,D,4,H), wh (R,H,4,H),
    b (R,4,H) -> (h', c') (R,B,H)."""
    if x.device.type == "cpu":
        return lstm_cell_ref(x, h, c, wx, wh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell_fused: no kernel for device {x.device}")
    if x.dim() != 3 or h.dim() != 3:
        raise ValueError(f"lstm_cell_fused: x must be (R,B,D) and h (R,B,H), "
                         f"got {tuple(x.shape)} and {tuple(h.shape)}")
    R, B, D = x.shape
    H = h.shape[-1]
    check_inputs("lstm_cell_fused", dict(x=x, h=h, c=c, wx=wx, wh=wh, b=b),
                 dict(h=(R, B, H), c=(R, B, H), wx=(R, D, 4, H),
                      wh=(R, H, 4, H), b=(R, 4, H)))
    if D + H > MAX_SMEM_FLOATS:
        raise ValueError(f"lstm_cell_fused: D+H={D + H} exceeds {MAX_SMEM_FLOATS}")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = _lib()
    rc = lib.lstm_cell_launch(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
        wh.data_ptr(), b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        R, B, D, H, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, rc, "lstm_cell_fused")
    lstm_cell_fused.launches += 1
    return h_out, c_out


lstm_cell_fused.launches = 0  # kernel launches since the count was last reset


def split_gates(a):
    """(..., 4H) packed i|f|g|o -> the kernel's (..., 4, H). Takes a numpy
    array or a tensor; leading axes are kept."""
    return a.reshape(*a.shape[:-1], 4, a.shape[-1] // 4)


def pack_weights(wx_flat: torch.Tensor, wh_flat: torch.Tensor,
                 b_flat: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., D, 4H) / (..., H, 4H) / (..., 4H) packed (i|f|g|o) -> kernel
    layout (..., D, 4, H) / (..., H, 4, H) / (..., 4, H). Leading (replica)
    axes are kept."""
    return split_gates(wx_flat), split_gates(wh_flat), split_gates(b_flat)
