"""Wrapper of the Hopper paged-attention kernel (``csrc/paged_attn.cu``).

Replaces the Pallas kernel ``repro/kernels/paged_attn/kernel.py::_kernel``
(``paged_attention_pallas``, behind
``repro/kernels/paged_attn/ops.py::paged_attention_fused``), and does the
same GQA reshape: q (B,T,Hq,D) is read as (B,T,Hkv,G,D), a view.

What bounds it on the H100: a launch must read each slot's assigned K/V
pages once, plus q, pos and the output, at 3.35 TB/s. At the served
shapes that is a few MB, a few microseconds, so a launch is bound by its
latency and by the page walk each block makes in turn; see the source.

One kernel serves the three shapes of the paged path: decode (T=1),
speculative verify (T=k+1) and a chunk of a prompt (T=chunk). On a CPU
tensor the wrapper computes the plain version in ``ref.py``. On a CUDA
tensor it launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (64, 128, 256)          # instantiated in csrc/paged_attn.cu
PAGE_SIZES = (4, 8, 16, 32)         # likewise; at most one key per lane
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attn")
    fn = lib.paged_attn_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_I] * 8 + [ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return lib


def _check(q, k_pool, v_pool, pos_pool, page_rows, qpos) -> None:
    what = "paged_attention_fused"
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, pos_pool=pos_pool,
                   page_rows=page_rows, qpos=qpos)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: q, k_pool and v_pool must share float32 or "
                        f"bfloat16, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    for name in ("pos_pool", "page_rows", "qpos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got "
                            f"{tensors[name].dtype}")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"{what}: q must be (B,T,Hq,D) and the pools "
                         f"(P,ps,Hkv,D), got {tuple(q.shape)} and "
                         f"{tuple(k_pool.shape)}")
    B, T, Hq, D = q.shape
    P, ps, Hkv = k_pool.shape[:3]
    shapes = dict(k_pool=(P, ps, Hkv, D), v_pool=(P, ps, Hkv, D),
                  pos_pool=(P, ps), qpos=(B, T))
    for name, want in shapes.items():
        if tuple(tensors[name].shape) != want:
            raise ValueError(f"{what}: {name} must be {want}, got "
                             f"{tuple(tensors[name].shape)}")
    if page_rows.dim() != 2 or page_rows.shape[0] != B:
        raise ValueError(f"{what}: page_rows must be (B,n), got "
                         f"{tuple(page_rows.shape)}")
    if Hq % Hkv:
        raise ValueError(f"{what}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if ps not in PAGE_SIZES:
        raise ValueError(f"{what}: page size {ps} not in {PAGE_SIZES}")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def paged_attention_fused(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, pos_pool: torch.Tensor,
                          page_rows: torch.Tensor, qpos: torch.Tensor, *,
                          window: int = 0, softcap: float = 0.0
                          ) -> torch.Tensor:
    """q (B,T,Hq,D) against the page pool -> (B,T,Hq,D), before the output
    projection. k/v_pool (P,ps,Hkv,D), pos_pool (P,ps) absolute positions
    (-1 empty), page_rows (B,n) page ids (-1 unassigned), qpos (B,T)
    absolute query positions. ``window=0`` turns the sliding window off,
    ``softcap=0`` the logit softcap."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, pos_pool, page_rows,
                                   qpos, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_fused: no kernel for device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, pos_pool, page_rows, qpos)
    B, T, Hq, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.paged_attn_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), page_rows.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), B, T, Hkv, Hq // Hkv, D, page_rows.shape[1], ps,
        int(window), float(softcap), _DTYPES[q.dtype], q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, rc, "paged_attention_fused")
    paged_attention_fused.launches += 1
    return out


paged_attention_fused.launches = 0  # kernel launches since the count was last reset
