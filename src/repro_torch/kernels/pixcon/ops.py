"""Wrapper of the Hopper Pix-Con gating kernel (``csrc/pixcon.cu``).

Replaces the Pallas kernel ``repro/kernels/pixcon/kernel.py::_pixcon_kernel``
(``pixcon_gate_pallas``, behind ``repro/kernels/pixcon/ops.py::pixcon_gate``).
It takes a leading replica axis on the weights, which is how the
reference's ``jax.vmap`` over watersheds batches the ``pallas_call``, and
it returns the gate weights ``w`` beside the gated input, because the
partitioner ranks pixels by them.

What bounds it on the H100: at the forecast's shapes one launch moves
about 0.4 MB and does about 0.6 MFLOP, far less than one launch's
latency, so the launch is a chain of dependent steps (stage the weights,
the tanh terms over all threads, each pixel's sum, the normalising sum,
the gated write), and the design keeps that chain short; see the source.
The wrapper's host path is kept short, as the conv1d and LSTM wrappers'
are: one test of the common case before the detailed checks, the raw
stream handle, and the arguments packed into one ctypes argument (the
temperature's reciprocal as a float32 field).

On a CPU tensor the wrapper computes the plain version in ``ref.py``. On
a CUDA tensor it launches the kernel or raises; nothing falls back.

Training: where a gradient is wanted (grad mode on and an input that
requires one), the launch goes through :class:`PixconGate`, an autograd
Function whose forward is the same launch and whose backward recomputes
the gate with the plain version and differentiates the gated input. ``w``
is marked non-differentiable: the partitioner only ranks pixels by
``w.detach()``, so on the Dom-ST path no gradient reaches it. The JAX
kernel has no backward either: the reference trains through ``jax.grad``
of its plain ``core/`` code. The forecast, under ``inference_mode``, keeps
the direct launch and its short host path. Both routes launch the kernel.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_inputs, plain_grads, stream_handle
from repro_torch.kernels.pixcon.ref import pixcon_gate_ref

MAX_PIXELS = 8192            # w (P floats) sits in the kernel's shared memory
# 18 int64 (pointers, shape, flags, device, stream), then 1 / temperature
_ARGS = struct.Struct("=18qf")


def _lib() -> ctypes.CDLL:
    lib = build.load("pixcon")
    if lib.pixcon_gate_launch.argtypes is None:
        lib.pixcon_gate_launch.argtypes = [ctypes.c_char_p]
        lib.pixcon_gate_launch.restype = ctypes.c_int
    return lib


def _check(x, feats, w1, b1, w2, b2, R: int, B: int, P: int, F: int,
           Hp: int) -> None:
    """Raise unless the inputs are what the kernel takes: one test of the
    common case, then, only where it fails, ``check_inputs``, which names
    the fault."""
    d = x.get_device()
    f32 = torch.float32
    ok = (feats.shape == (R, B, P, F) and w1.shape[0] == R
          and b1.shape == (R, Hp)
          and w2.shape == (R, Hp) and b2.shape == (R, 1))
    for t in (x, feats, w1, b1, w2, b2):
        ok = ok and t.dtype is f32 and t.is_contiguous() and t.get_device() == d
    if not ok:
        check_inputs("pixcon_gate",
                     dict(x=x, feats=feats, w1=w1, b1=b1, w2=w2, b2=b2),
                     dict(feats=(R, B, P, F), w1=(R, F, Hp), b1=(R, Hp),
                          w2=(R, Hp), b2=(R, 1)))


def pixcon_gate(x: torch.Tensor, feats: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
                temperature: float = 1.0, normalize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Pix-Con gate. x (R,B,T,P), feats (R,B,P,F), w1 (R,F,Hp),
    b1 (R,Hp), w2 (R,Hp), b2 (R,1) -> (gated x (R,B,T,P), w (R,B,P))."""
    if not x.is_cuda:
        kind = x.device.type
        if kind == "cpu":
            return pixcon_gate_ref(x, feats, w1, b1, w2, b2,
                                   temperature=temperature,
                                   normalize=normalize)
        if kind != "cuda":
            raise ValueError(f"pixcon_gate: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (
            x.requires_grad or feats.requires_grad or w1.requires_grad
            or b1.requires_grad or w2.requires_grad or b2.requires_grad):
        return PixconGate.apply(x, feats, w1, b1, w2, b2, temperature,
                                normalize)
    return _launch(x, feats, w1, b1, w2, b2, temperature, normalize)


class PixconGate(torch.autograd.Function):
    """The kernel's launch forward; backward by autograd through the plain
    version of the gated input, recomputed from the saved inputs. ``w`` is
    non-differentiable. Inputs that need no gradient (``precip`` and the
    pixel features are data) get none."""

    @staticmethod
    def forward(ctx, x, feats, w1, b1, w2, b2, temperature, normalize):
        ctx.save_for_backward(x, feats, w1, b1, w2, b2)
        ctx.temperature, ctx.normalize = temperature, normalize
        out, w = _launch(x, feats, w1, b1, w2, b2, temperature, normalize)
        ctx.mark_non_differentiable(w)
        return out, w

    @staticmethod
    def backward(ctx, g_out, _g_w):
        return (*plain_grads(
            lambda *t: pixcon_gate_ref(*t, temperature=ctx.temperature,
                                       normalize=ctx.normalize),
            ctx.saved_tensors, ctx.needs_input_grad[:6], (g_out, None)),
            None, None)


def _launch(x: torch.Tensor, feats: torch.Tensor, w1: torch.Tensor,
            b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            temperature: float, normalize: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the kernel on tensors on the card."""
    try:
        (R, B, T, P), (_, F, Hp) = x.shape, w1.shape
    except ValueError:
        raise ValueError(f"pixcon_gate: x must be (R,B,T,P) and w1 (R,F,Hp), "
                         f"got {tuple(x.shape)} and {tuple(w1.shape)}") from None
    _check(x, feats, w1, b1, w2, b2, R, B, P, F, Hp)
    if P > MAX_PIXELS:
        raise ValueError(f"pixcon_gate: P={P} exceeds {MAX_PIXELS}")
    lib = _lib()
    out = torch.empty_like(x)
    w = x.new_empty((R, B, P))
    dev = x.get_device()
    xp, op = x.data_ptr(), out.data_ptr()
    rc = lib.pixcon_gate_launch(_ARGS.pack(
        xp, feats.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), op, w.data_ptr(), R, B, T, P, F, Hp, normalize,
        P % 4 == 0 and (xp | op) % 16 == 0, dev, stream_handle(dev),
        1.0 / temperature))
    if rc:
        build.check_launch(lib, rc, "pixcon_gate")
    pixcon_gate.launches += 1
    return out, w


pixcon_gate.launches = 0     # kernel launches since the count was last reset
