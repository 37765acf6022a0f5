"""Where the references compute their contractions, and in what
precision: float32 (the references' own), or the lower precision of a
control run, emulated so that it computes the same on the CPU and on
the card.

* ``tf32``: each operand of a contraction rounded to TF32 (10 mantissa
  bits, round to nearest even), the product accumulated in float32: what
  a TF32 tensor core does. The gradient of the product is taken the same
  way, from the rounded operands and the rounded incoming gradient.
* ``fp8``: each operand scaled by its largest magnitude onto float8 e4m3
  (448 at most) and back: per-tensor fp8 matrix products, forward and
  backward; and each activation held in fp8 where ``act`` is called on
  it (the tensors a bfloat16 program holds in bfloat16), its gradient
  too.
"""
from __future__ import annotations

from typing import Callable

import torch

MODES = ("fp32", "tf32", "fp8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding only TF32's 10 mantissa bits, rounded to
    nearest even."""
    i = x.float().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    r = torch.bitwise_and(i + 0xFFF + lsb, -0x2000)
    return r.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 at a per-tensor scale (its largest magnitude
    onto 448), back in x's dtype."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
    return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)


class _Lowered(torch.autograd.Function):
    """``fn(q(a), q(b))``, its gradients from the rounded operands and the
    rounded incoming gradient."""

    @staticmethod
    def forward(ctx, fn, q, a, b):
        ctx.fn, ctx.q = fn, q
        ctx.save_for_backward(a, b)
        return fn(q(a), q(b))

    @staticmethod
    def backward(ctx, gy):
        a, b = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            qa = ctx.q(a).detach().requires_grad_(need[0])
            qb = ctx.q(b).detach().requires_grad_(need[1])
            y = ctx.fn(qa, qb)
            wrt = [t for t, n in zip((qa, qb), need) if n]
            grads = iter(torch.autograd.grad(y, wrt, ctx.q(gy)))
        return (None, None, *(next(grads) if n else None for n in need))


class _Held(torch.autograd.Function):
    """``q(x)``, and ``q`` of its incoming gradient."""

    @staticmethod
    def forward(ctx, q, x):
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.q(g)


class Precision:
    """The contraction of two operands in ``mode`` (one of ``MODES``)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} not in {MODES}")
        self.mode = mode
        self._q = {"tf32": round_tf32, "fp8": round_fp8}.get(mode)

    def __call__(self, fn: Callable, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
        if self._q is None:
            return fn(a, b)
        return _Lowered.apply(fn, self._q, a, b)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the mode holds it: rounded to fp8 in ``fp8``,
        as it is in the others."""
        return _Held.apply(self._q, x) if self.mode == "fp8" else x

    def einsum(self, spec: str, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        return self(lambda x, y: torch.einsum(spec, x, y), a, b)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self(torch.matmul, a, b)
