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
its causal pairs, ~3.3 us at 3.35 TB/s. One launch does the y tiles and
the states, in blocks of one grid (``plan_ssd``). In bf16 both products
of y and the state run on the tensor cores (``mma.sync``; the decayed
scores enter y's second product as two bf16 terms, B times its decay the
state's as three), so y stays within a bf16 ulp of the plain version and
the state within 1e-5; float32 keeps the CUDA-core arithmetic, which
matches the plain version to the bit. See the source.

The kernel computes in float32, as the Pallas kernel does, where the
reference's model code rounds through the activation dtype: in bfloat16
the two differ by a few ulps, in float32 they agree. The wrapper's host
path is kept short, as the conv1d and LSTM wrappers' are: one test of the
common case before the detailed checks, the raw stream handle, the plan
looked up in a cache, and the arguments (plan included) packed into one
ctypes argument. On a CPU tensor the wrapper computes the plain version
in ``ref.py``. On a CUDA tensor it launches the kernel or raises; nothing
falls back.

Training: where a gradient is wanted (grad mode on and an input that
requires one), the launch goes through :class:`SsdChunk`, an autograd
Function whose forward is the same launch and whose backward recomputes
both outputs with the plain version from the saved inputs and
differentiates them (``Cc``, ``Bc``, ``xdt`` and ``dA_cs``, through
``y_diag`` and ``states``). The JAX kernel has no backward either: the
reference trains through ``jax.grad`` of its plain ``ssd_chunked``.
Serving, with grad mode off, keeps the direct launch.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (
    DTYPE_CODES, check_activations, plain_grads, stream_handle,
)
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

MAX_N, MAX_P = 256, 64      # state width and head width the kernel takes
TILE = {4: 64, 2: 32}       # query rows a y block, by element size (kTile, kQTile)
SLICE = 64                  # columns of P and of N a state block (kSliceN)
KSTEPS = (4, 8, 16)         # bf16: the instantiations' k-steps of C.B^T
# the state blocks first where they are among the launch's longest blocks
# (bf16, whose y blocks are 32-row tiles), else the heaviest y blocks first
STATE_FIRST = {4: False, 2: True}
_ARGS = struct.Struct("21q")


class SsdPlan(NamedTuple):
    vec: bool        # 16-byte cp.async copies (else element loads)
    ksteps: int      # bf16: k-steps of 16 over N (N padded to 16*ksteps); fp32 0
    qtiles: int      # query tiles a (batch*chunk, head): 64 rows fp32, 32 bf16
    slices: int      # state slices a (batch*chunk, head)
    y_blocks: int    # qtiles * H * BN
    blocks: int      # y_blocks + slices * H * BN
    state_first: bool  # the state blocks take the first block indices


@functools.lru_cache(maxsize=1024)
def plan_ssd(BN: int, Q: int, H: int, N: int, P: int, esize: int,
             aligned: bool) -> SsdPlan:
    """How a launch of ``csrc/ssd_chunk.cu`` is laid out; the kernel takes
    the plan as it is given (and refuses one it cannot run).

    One y block per (query tile of ``TILE[esize]`` rows, head, batch*chunk)
    and one state block per (slice of 64 columns of P x 64 of N, head,
    batch*chunk). In the order y blocks, then state blocks, position b <
    y_blocks takes query tile qtiles-1 - b // (H*BN) (the tiles with the
    most key tiles first), head b % H and batch*chunk (b % (H*BN)) // H;
    position s = b - y_blocks takes slice s % slices (P slice slice //
    ceil(N/64), N slice slice % ceil(N/64)), head (s // slices) % H and
    batch*chunk s // (slices*H). Block i takes position i, or with
    ``state_first`` the state blocks take blocks 0.. and the y blocks
    follow. 16-byte copies where N and P are multiples of 16 bytes'
    elements and every pointer is 16-byte aligned (``aligned``); else
    element loads. bf16 takes the smallest instantiation whose 16*ksteps
    columns hold N."""
    v = 16 // esize
    vec = aligned and N % v == 0 and P % v == 0
    ksteps = 0 if esize == 4 else next(k for k in KSTEPS if 16 * k >= N)
    qtiles = -(-Q // TILE[esize])
    slices = -(-P // SLICE) * -(-N // SLICE)
    y_blocks = qtiles * H * BN
    return SsdPlan(vec, ksteps, qtiles, slices, y_blocks,
                   y_blocks + slices * H * BN, STATE_FIRST[esize])


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_chunk")
    if lib.ssd_chunk_launch.argtypes is None:
        lib.ssd_chunk_launch.argtypes = [ctypes.c_char_p]
        lib.ssd_chunk_launch.restype = ctypes.c_int
    return lib


def _check(Cc, Bc, xdt, dA_cs, B: int, nc: int, Q: int, H: int, N: int,
           P: int) -> int:
    """Raise unless the inputs are what the kernel takes; return the dtype
    flag of the launch. One test of the common case, then, only where it
    fails, ``check_activations``, which names the fault."""
    dt = xdt.dtype
    code = DTYPE_CODES.get(dt)
    d = xdt.get_device()
    if (code is None or Cc.dtype is not dt or Bc.dtype is not dt
            or dA_cs.dtype is not torch.float32
            or not (xdt.is_contiguous() and Cc.is_contiguous()
                    and Bc.is_contiguous() and dA_cs.is_contiguous())
            or Cc.get_device() != d or Bc.get_device() != d
            or dA_cs.get_device() != d
            or Bc.shape != (B, nc, Q, H, N) or xdt.shape[:4] != (B, nc, Q, H)
            or dA_cs.shape != (B, nc, H, Q)):
        code = check_activations(
            "ssd_chunk_fused", dict(xdt=xdt, Cc=Cc, Bc=Bc, dA_cs=dA_cs),
            dict(Cc=(B, nc, Q, H, N), Bc=(B, nc, Q, H, N),
                 xdt=(B, nc, Q, H, P), dA_cs=(B, nc, H, Q)), fp32=("dA_cs",))
    return code


def ssd_chunk_fused(Cc: torch.Tensor, Bc: torch.Tensor, xdt: torch.Tensor,
                    dA_cs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cc/Bc (B,nc,Q,H,N), xdt (B,nc,Q,H,P) of one dtype, dA_cs (B,nc,H,Q)
    float32 -> (y_diag (B,nc,Q,H,P) in xdt's dtype, states (B,nc,H,P,N)
    float32)."""
    if not Cc.is_cuda:
        kind = Cc.device.type
        if kind == "cpu":
            return ssd_chunk_ref(Cc, Bc, xdt, dA_cs)
        if kind != "cuda":
            raise ValueError(f"ssd_chunk_fused: no kernel for device {Cc.device}")
    if torch.is_grad_enabled() and (
            Cc.requires_grad or Bc.requires_grad or xdt.requires_grad
            or dA_cs.requires_grad):
        return SsdChunk.apply(Cc, Bc, xdt, dA_cs)
    return _launch(Cc, Bc, xdt, dA_cs)


class SsdChunk(torch.autograd.Function):
    """The kernel's launch forward; backward by autograd through the plain
    version of both outputs, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, Cc, Bc, xdt, dA_cs):
        ctx.save_for_backward(Cc, Bc, xdt, dA_cs)
        return _launch(Cc, Bc, xdt, dA_cs)

    @staticmethod
    def backward(ctx, g_y, g_states):
        return plain_grads(ssd_chunk_ref, ctx.saved_tensors,
                           ctx.needs_input_grad, (g_y, g_states))


def _launch(Cc: torch.Tensor, Bc: torch.Tensor, xdt: torch.Tensor,
            dA_cs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs and launch the kernel on tensors on the card."""
    if Cc.dim() != 5 or xdt.dim() != 5:
        raise ValueError(f"ssd_chunk_fused: Cc must be (B,nc,Q,H,N) and xdt "
                         f"(B,nc,Q,H,P), got {tuple(Cc.shape)} and "
                         f"{tuple(xdt.shape)}")
    B, nc, Q, H, N = Cc.shape
    P = xdt.shape[4]
    code = _check(Cc, Bc, xdt, dA_cs, B, nc, Q, H, N, P)
    if N > MAX_N or P > MAX_P:
        raise ValueError(f"ssd_chunk_fused: N={N} or P={P} above the "
                         f"kernel's {MAX_N} and {MAX_P}")
    lib = _lib()
    y = torch.empty_like(xdt)
    states = xdt.new_empty((B, nc, H, P, N), dtype=torch.float32)
    dev = xdt.get_device()
    ptrs = (Cc.data_ptr(), Bc.data_ptr(), xdt.data_ptr(), dA_cs.data_ptr(),
            y.data_ptr(), states.data_ptr())
    p = plan_ssd(B * nc, Q, H, N, P, 2 if code else 4,
                 (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4] | ptrs[5])
                 % 16 == 0)
    rc = lib.ssd_chunk_launch(_ARGS.pack(
        *ptrs, B * nc, Q, H, N, P, code, dev, stream_handle(dev), *p))
    if rc:
        build.check_launch(lib, rc, "ssd_chunk_fused")
    ssd_chunk_fused.launches += 1
    return y, states


ssd_chunk_fused.launches = 0  # kernel launches since the count was last reset
