"""Wrapper of the Hopper causal depthwise conv1d kernel (``csrc/conv1d.cu``).

Replaces the Pallas kernel ``repro/kernels/conv1d/kernel.py::_conv_kernel``
(``causal_conv1d_pallas``, behind ``repro/kernels/conv1d/ops.py::
causal_conv1d``). The Pallas wrapper cuts S into 2,048-row pieces for
VMEM and carries the K-1 tail between them; the CUDA kernel reads any S
in one launch, takes that tail as an input instead of the zero pad, which
is also what a decode or chunk step of the model needs (the reference's
``ssm._causal_conv`` and ``rglru._conv`` with ``tail=``), and writes the
new tail in the same launch.

What bounds it on the H100: bytes. A launch reads x, w and b once and
writes y: a 512-token Mamba-2 prefill layer (bf16, C=1,792) moves ~3.7 MB,
1.10 us at 3.35 TB/s; recurrentgemma-2b's 2,560-token layer 26.2 MB,
7.83 us. A decode step (S=1) is latency-bound, and there the wrapper's
host time is the call. So the kernel reads 16-byte vectors along the
channels and slides a window of K-1 rows down a run of steps
(``plan_conv``; see the source), and the wrapper's host path is kept
short: one test of the common case before the detailed checks, the raw
stream handle, the plan looked up in a cache, the arguments (plan
included) packed into one ctypes argument, and no ``torch.cat`` for the
new tail.

The kernel accumulates in float32, as the Pallas kernel does, where the
reference's model code sums bfloat16 products: in bfloat16 the two differ
by a few ulps, in float32 they agree. On a CPU tensor the wrapper
computes the plain version in ``ref.py``. On a CUDA tensor it launches the
kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    DTYPE_CODES, check_activations, sm_count, stream_handle,
)
from repro_torch.kernels.conv1d.ref import ACTIVATIONS, causal_conv1d_ref

THREADS = 128          # kThreads in csrc/conv1d.cu: threads a block
RESIDENT = 1024        # threads an SM holds at this kernel's size
MAX_RUN = 16           # longest run of steps a thread
_ARGS = struct.Struct("17q")


class ConvPlan(NamedTuple):
    vector: bool    # 16-byte accesses (else one channel a thread)
    width: int      # channels a thread
    run: int        # L, consecutive steps a thread
    runs: int       # runs a (batch row, channel group): ceil(S / L)
    blocks: int     # of THREADS threads


@functools.lru_cache(maxsize=1024)
def plan_conv(B: int, S: int, C: int, esize: int, aligned: bool,
              sms: int = 132) -> ConvPlan:
    """How a launch of ``csrc/conv1d.cu`` is laid out; the kernel takes the
    plan as it is given (and refuses a vector plan off alignment).

    16-byte vectors where C is a multiple of the vector width, every
    pointer (x, tail, w, b, y, new tail) is 16-byte aligned (``aligned``)
    and the launch has at least one block of channel vectors an SM; else
    the scalar path (a small launch is bound by its latency, and one
    channel a thread spreads it over more threads). The run L starts at 1
    and doubles, up to 16, while the (batch row, run, channel group) items
    still fill two waves of ``sms * RESIDENT`` threads: a decode step gets
    L=1, a long prefill a few steps a thread. Thread i of the grid takes
    channel group i % cols, run (i // cols) % runs and batch row
    i // (cols * runs)."""
    width = 16 // esize
    vector = (aligned and C % width == 0
              and B * S * (C // width) >= sms * THREADS)
    if not vector:
        width = 1
    cols = C // width
    run = 1
    while run < MAX_RUN and B * -(-S // (2 * run)) * cols >= 2 * sms * RESIDENT:
        run *= 2
    runs = -(-S // run) if S > 0 else 1
    return ConvPlan(vector, width, run, runs, -(-(B * runs * cols) // THREADS))


def _lib() -> ctypes.CDLL:
    lib = build.load("conv1d")
    if lib.conv1d_launch.argtypes is None:
        lib.conv1d_launch.argtypes = [ctypes.c_char_p]
        lib.conv1d_launch.restype = ctypes.c_int
    return lib


def _check(x, w, b, tail, B: int, C: int, K: int) -> int:
    """Raise unless the inputs are what the kernel takes; return the dtype
    flag of the launch. One test of the common case, then, only where it
    fails, ``check_activations``, which names the fault."""
    dt = x.dtype
    code = DTYPE_CODES.get(dt)
    d = x.get_device()
    if (code is None or w.dtype is not dt or b.dtype is not dt
            or not (x.is_contiguous() and w.is_contiguous()
                    and b.is_contiguous())
            or w.get_device() != d or b.get_device() != d
            or w.shape[1] != C or b.shape != (C,)
            or (tail is not None
                and (tail.dtype is not dt or not tail.is_contiguous()
                     or tail.get_device() != d
                     or tail.shape != (B, K - 1, C)))):
        tensors = dict(x=x, w=w, b=b)
        if tail is not None:
            tensors["tail"] = tail
        code = check_activations("causal_conv1d", tensors,
                                 dict(w=(K, C), b=(C,), tail=(B, K - 1, C)))
    return code << 1


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  activation: str = "none",
                  tail: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,C), w (K,C), b (C,) in x's dtype, tail (B,K-1,C) in x's
    dtype or None (zeros) -> (y (B,S,C) in x's dtype, new tail (B,K-1,C),
    the last K-1 rows of ``[tail, x]``; on the card a tensor of its own)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    if not x.is_cuda:
        kind = x.device.type
        if kind == "cpu":
            return causal_conv1d_ref(x, w, b, activation=activation, tail=tail)
        if kind != "cuda":
            raise ValueError(f"causal_conv1d: no kernel for device {x.device}")
    try:
        (B, S, C), (K, _) = x.shape, w.shape
    except ValueError:
        raise ValueError(f"causal_conv1d: x must be (B,S,C) and w (K,C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}") from None
    flags = _check(x, w, b, tail, B, C, K) | (activation == "silu")
    lib = _lib()
    y = torch.empty_like(x)
    tail_out = x.new_empty((B, K - 1, C)) if tail is None else \
        torch.empty_like(tail)
    dev = x.get_device()
    ptrs = (x.data_ptr(), 0 if tail is None else tail.data_ptr(),
            w.data_ptr(), b.data_ptr(), y.data_ptr(), tail_out.data_ptr())
    p = plan_conv(B, S, C, 2 if flags & 2 else 4,
                  (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4] | ptrs[5])
                  % 16 == 0, sm_count(dev))
    rc = lib.conv1d_launch(_ARGS.pack(
        *ptrs, B, S, C, K, flags, dev, stream_handle(dev), p.vector, p.run,
        p.runs, p.blocks))
    if rc:
        build.check_launch(lib, rc, "causal_conv1d")
    causal_conv1d.launches += 1
    return y, tail_out


causal_conv1d.launches = 0  # kernel launches since the count was last reset
