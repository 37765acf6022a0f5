"""Wrapper of the Hopper fused LSTM-step kernel (``csrc/lstm_cell.cu``),
plus the layout adapter from the packed ``(D, 4H)`` gate layout.

Replaces the Pallas kernel
``repro/kernels/lstm_cell/kernel.py::_lstm_kernel`` (``lstm_cell_pallas``,
behind ``repro/kernels/lstm_cell/ops.py::lstm_cell_fused``), with
per-replica weights: the reference's ``jax.vmap`` over watersheds written
out as a leading axis R.

What bounds it on the H100: every launch reads all replicas' weights
once, 4.5 MB (layer 0) and 3.0 MB (layer 1) at the forecast's shapes,
1.14 us averaged over the two at 3.35 TB/s; they sit in the 50 MB L2
across the forecast's 4,440 steps, so one L2 pass plus the launch is the
floor. The kernel spreads each step over the card: one block per
(replica, tile of examples, tile of hidden units), its weight tile staged
in shared memory by ``cp.async`` with every copy in flight at once, K
split over the warps and summed in a fixed order (``plan_lstm``; see the
source). With the kernel at a few microseconds, the forecast's 4,440
calls are bound by the wrapper's host time, so that is kept short: one
test of the common case before the detailed checks, the raw stream
handle, the plan looked up in a cache, and the arguments (plan included)
packed into one ctypes argument.

On a CPU tensor the wrapper computes the plain version in ``ref.py``. On
a CUDA tensor it launches the kernel or raises; nothing falls back.

Training: where a gradient is wanted (grad mode on and an input that
requires one), the launch goes through :class:`LstmCell`, an autograd
Function whose forward is the same launch and whose backward recomputes
the step with the plain version and differentiates it. The JAX kernel
has no backward either: the reference trains through ``jax.grad`` of its
plain ``core/`` code. The forecast, under ``inference_mode``, keeps the
direct launch and its short host path. Both routes launch the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_inputs, sm_count, stream_handle
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref

MAX_SMEM_FLOATS = 12 * 1024  # D+H the kernel takes (its x|h rows in shared memory)
THREADS = 256                # kThreads in csrc/lstm_cell.cu: threads a block
MAX_BT = 8                   # examples a block at most
XH_BYTES = 96 * 1024         # the block's x|h rows at most
RING_BYTES = 64 * 1024       # the weight tile (or its 2 stages) at most
_ARGS = struct.Struct("21q")


class LstmPlan(NamedTuple):
    ju: int          # hidden units a block
    bt: int          # examples a block
    rows: int        # K rows a stage of the weight tile
    stages: int      # 1: the whole tile at once; 2: a ring of row slices
    vec16: bool      # 16-byte copies (else 4-byte)
    blocks: int
    smem: int        # bytes of shared memory a block


@functools.lru_cache(maxsize=1024)
def plan_lstm(R: int, B: int, D: int, H: int, sms: int = 132,
              aligned: bool = True) -> LstmPlan:
    """How a launch of ``csrc/lstm_cell.cu`` is laid out; the kernel takes
    the plan as it is given.

    Blocks are (replica, tile of ``bt`` examples, tile of ``ju`` units),
    units fastest. ``bt`` starts at the largest power of two up to
    min(B, 8) whose x|h rows fit 96 KB, and halves while the blocks fall
    short of ``sms``; then ``ju`` goes from 8 to 4 if they still do. A
    block stages its (K, 4, ju) weight tile, K = D+H, at once where it
    fits 64 KB, else in a 2-stage ring of row slices; by 16-byte copies
    where wx and wh are 16-byte aligned (``aligned``) and H is a multiple
    of 4. Block i takes unit tile i % jtiles, example tile
    (i // jtiles) % btiles and replica i // (jtiles * btiles)."""
    K = D + H
    bt = 1
    while bt * 2 <= min(B, MAX_BT) and bt * 2 * K * 4 <= XH_BYTES:
        bt *= 2
    ju = 8

    def blocks():
        return R * -(-B // bt) * -(-H // ju)
    while blocks() < sms and bt > 1:
        bt //= 2
    if blocks() < sms:
        ju = 4
    row_bytes = 16 * ju
    rows, stages = (K, 1) if K * row_bytes <= RING_BYTES else \
        (RING_BYTES // 2 // row_bytes, 2)
    # weight stages, x|h rows, the K slices' partial sums, the gate sums
    smem = 4 * (stages * rows * 4 * ju + bt * K + THREADS * bt + bt * 4 * ju)
    return LstmPlan(ju, bt, rows, stages, aligned and H % 4 == 0, blocks(),
                    smem)


def _lib() -> ctypes.CDLL:
    lib = build.load("lstm_cell")
    if lib.lstm_cell_launch.argtypes is None:
        lib.lstm_cell_launch.argtypes = [ctypes.c_char_p]
        lib.lstm_cell_launch.restype = ctypes.c_int
    return lib


def _check(x, h, c, wx, wh, b, R: int, B: int, D: int, H: int) -> None:
    """Raise unless the inputs are what the kernel takes: one test of the
    common case, then, only where it fails, ``check_inputs``, which names
    the fault."""
    d = x.get_device()
    f32 = torch.float32
    ok = (h.shape == (R, B, H) and c.shape == (R, B, H)
          and wx.shape == (R, D, 4, H) and wh.shape == (R, H, 4, H)
          and b.shape == (R, 4, H))
    for t in (x, h, c, wx, wh, b):
        ok = ok and t.dtype is f32 and t.is_contiguous() and t.get_device() == d
    if not ok:
        check_inputs("lstm_cell_fused", dict(x=x, h=h, c=c, wx=wx, wh=wh, b=b),
                     dict(h=(R, B, H), c=(R, B, H), wx=(R, D, 4, H),
                          wh=(R, H, 4, H), b=(R, 4, H)))


def lstm_cell_fused(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LSTM step. x (R,B,D), h/c (R,B,H), wx (R,D,4,H), wh (R,H,4,H),
    b (R,4,H) -> (h', c') (R,B,H)."""
    if not x.is_cuda:
        kind = x.device.type
        if kind == "cpu":
            return lstm_cell_ref(x, h, c, wx, wh, b)
        if kind != "cuda":
            raise ValueError(f"lstm_cell_fused: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or h.requires_grad or c.requires_grad
            or wx.requires_grad or wh.requires_grad or b.requires_grad):
        return LstmCell.apply(x, h, c, wx, wh, b)
    return _launch(x, h, c, wx, wh, b)


class LstmCell(torch.autograd.Function):
    """The kernel's launch forward; backward by autograd through the plain
    version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, h, c, wx, wh, b):
        ctx.save_for_backward(x, h, c, wx, wh, b)
        return _launch(x, h, c, wx, wh, b)

    @staticmethod
    def backward(ctx, g_h, g_c):
        needs = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = lstm_cell_ref(*inputs)
            grads = iter(torch.autograd.grad(
                outs, [t for t, n in zip(inputs, needs) if n], (g_h, g_c),
                allow_unused=True))
        return tuple(next(grads) if n else None for n in needs)


def _launch(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
            wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the kernel on tensors on the card."""
    try:
        (R, B, D), (_, _, H) = x.shape, h.shape
    except ValueError:
        raise ValueError(f"lstm_cell_fused: x must be (R,B,D) and h (R,B,H), "
                         f"got {tuple(x.shape)} and {tuple(h.shape)}") from None
    _check(x, h, c, wx, wh, b, R, B, D, H)
    if D + H > MAX_SMEM_FLOATS:
        raise ValueError(f"lstm_cell_fused: D+H={D + H} exceeds {MAX_SMEM_FLOATS}")
    lib = _lib()
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    dev = x.get_device()
    wxp, whp = wx.data_ptr(), wh.data_ptr()
    p = plan_lstm(R, B, D, H, sm_count(dev), (wxp | whp) % 16 == 0)
    rc = lib.lstm_cell_launch(_ARGS.pack(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), wxp, whp, b.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), R, B, D, H, dev,
        stream_handle(dev), *p))
    if rc:
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
