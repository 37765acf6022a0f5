"""Wrapper of the Hopper paged-attention kernel (``csrc/paged_attn.cu``).

Replaces the Pallas kernel ``repro/kernels/paged_attn/kernel.py::_kernel``
(``paged_attention_pallas``, behind
``repro/kernels/paged_attn/ops.py::paged_attention_fused``), and does the
same GQA reshape: q (B,T,Hq,D) is read as (B,T,Hkv,G,D), a view.

What bounds it on the H100: a launch must read each slot's assigned K/V
pages once, plus q, pos and the output, at 3.35 TB/s. At the served
shapes that is a few MB, a few microseconds, so a launch is bound by how
many pages are in flight at once. The kernel therefore splits each slot's
page row over blocks (split-K): ``plan_splits`` picks the pages a split
takes so that decode and verify put at least one block on every SM, and
a second kernel merges the splits' partial softmaxes; see the source.

One kernel serves the three shapes of the paged path: decode (T=1),
speculative verify (T=k+1) and a chunk of a prompt (T=chunk). On a CPU
tensor the wrapper computes the plain version in ``ref.py``. On a CUDA
tensor it launches the kernel or raises; nothing falls back.

The host path is kept short, as the other wrappers' are: one test of the
common case before the detailed checks (``_check``, which names the
fault), the raw stream handle, and the arguments packed into one ctypes
argument (the softcap as a float32 field).
"""
from __future__ import annotations

import ctypes
import math
import struct

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import sm_count, stream_handle
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

HEAD_DIMS = (64, 128, 256)          # instantiated in csrc/paged_attn.cu
PAGE_SIZES = (4, 8, 16, 32)         # likewise
ROWS_PER_BLOCK = 16                 # kRows in csrc/paged_attn.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# 20 int64 (pointers, shape, plan, window, dtype, device, stream), then the
# softcap
_ARGS = struct.Struct("=20qf")


def plan_splits(B: int, Hkv: int, row_tiles: int, n: int,
                sm_count: int) -> int:
    """Pages of a slot's page row that one block takes (``pages_per_split``).

    The kernel runs ``B * Hkv * row_tiles`` work items (16 query rows of
    one slot and KV head each), every one split over ``ceil(n /
    pages_per_split)`` blocks. Where the work items alone fill the
    ``sm_count`` SMs (long chunks over several slots) there is one split
    and no merge. Otherwise the splits are as large as they can be while
    the blocks still reach ``sm_count`` times the row tiles a (slot, KV
    head) has, up to 8: decode (one tile) is bound by bytes and wants few
    partials to merge, a chunk of one slot (80 tiles at recurrentgemma-2b)
    by its FMAs and wants several waves of blocks, so that the last wave
    is short. A row too short for that gets one page a split."""
    items = B * Hkv * row_tiles
    if n <= 1 or items >= sm_count:
        return max(n, 1)
    need = -(-sm_count * min(row_tiles, 8) // items)    # splits per item
    return max(1, n // need)


def grid_of(B: int, T: int, Hq: int, Hkv: int, n: int,
            sm_count: int) -> tuple[int, int, int]:
    """(pages_per_split, splits, blocks of the first kernel) of a launch
    with q (B,T,Hq,D) and page rows of ``n`` entries."""
    row_tiles = -(-T * (Hq // Hkv) // ROWS_PER_BLOCK)
    pps = plan_splits(B, Hkv, row_tiles, n, sm_count)
    splits = max(1, -(-n // pps))
    return pps, splits, B * Hkv * row_tiles * splits


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attn")
    if lib.paged_attn_launch.argtypes is None:
        lib.paged_attn_launch.argtypes = [ctypes.c_char_p]
        lib.paged_attn_launch.restype = ctypes.c_int
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


def _fits(q, k_pool, v_pool, pos_pool, page_rows, qpos) -> bool:
    """One test of the common case: what ``_check`` holds, in one pass."""
    if q.dim() != 4 or k_pool.dim() != 4 or page_rows.dim() != 2:
        return False
    B, T, Hq, D = q.shape
    P, ps, Hkv = k_pool.shape[:3]
    dt, i32, d = q.dtype, torch.int32, q.get_device()
    return (dt in _DTYPES and k_pool.dtype is dt and v_pool.dtype is dt
            and pos_pool.dtype is i32 and page_rows.dtype is i32
            and qpos.dtype is i32
            and q.is_contiguous() and k_pool.is_contiguous()
            and v_pool.is_contiguous() and pos_pool.is_contiguous()
            and page_rows.is_contiguous() and qpos.is_contiguous()
            and k_pool.get_device() == d and v_pool.get_device() == d
            and pos_pool.get_device() == d and page_rows.get_device() == d
            and qpos.get_device() == d
            and k_pool.shape[3] == D and v_pool.shape == k_pool.shape
            and pos_pool.shape == (P, ps) and qpos.shape == (B, T)
            and page_rows.shape[0] == B
            and Hkv > 0 and Hq % Hkv == 0 and D in HEAD_DIMS
            and ps in PAGE_SIZES
            and (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16
            == 0)


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
    if not (softcap >= 0.0 and math.isfinite(softcap)):
        raise ValueError(f"paged_attention_fused: softcap must be finite and "
                         f">= 0, got {softcap}")
    if not q.is_cuda:
        kind = q.device.type
        if kind == "cpu":
            return paged_attention_ref(q, k_pool, v_pool, pos_pool,
                                       page_rows, qpos, window=window,
                                       softcap=softcap)
        if kind != "cuda":
            raise ValueError(f"paged_attention_fused: no kernel for device "
                             f"{q.device}")
    if not _fits(q, k_pool, v_pool, pos_pool, page_rows, qpos):
        _check(q, k_pool, v_pool, pos_pool, page_rows, qpos)
    B, T, Hq, D = q.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    n = page_rows.shape[1]
    lib = _lib()
    dev = q.get_device()
    pps, splits, _ = grid_of(B, T, Hq, Hkv, n, sm_count(dev))
    out = torch.empty_like(q)
    # each split's float32 partial of every (slot, query row): acc[D], m, l
    part = (q.new_empty(B * splits * T * Hq * (D + 2), dtype=torch.float32)
            if splits > 1 else None)
    rc = lib.paged_attn_launch(_ARGS.pack(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), page_rows.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), B, T, Hkv,
        Hq // Hkv, D, n, ps, pps, window, _DTYPES[q.dtype], dev,
        stream_handle(dev), softcap))
    if rc:
        build.check_launch(lib, rc, "paged_attention_fused")
    paged_attention_fused.launches += 1
    return out


paged_attention_fused.launches = 0  # calls that launched the kernel (and its merge, if any)
