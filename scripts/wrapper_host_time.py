#!/usr/bin/env python3
"""Where the host time of a conv1d, LSTM-step, Pix-Con, SSD-chunk,
local-attention and paged-attention wrapper call goes, on one NVIDIA GPU.

    python3 scripts/wrapper_host_time.py [SRC]

Times the wrappers of the port found in SRC, a ``src`` directory (default:
this checkout's), at mamba2-130m's 4-slot decode step (``causal_conv1d``,
bf16, B=4, S=1, C=1,792, K=4, SiLU, with a tail), at the Dom-ST
forecast's first LSTM layer (``lstm_cell_fused``, R=23, B=1, D=128,
H=64), at the forecast's Pix-Con gate (``pixcon_gate``, R=23, B=1, T=30,
P=64, F=4, Hp=32), at mamba2-130m's 512-token prefill layer
(``ssd_chunk_fused``, bf16, B=1, nc=2, Q=256, H=24, N=128, P=64), and
at gemma2-2b's head shapes (8 query heads on 4, D=256, bf16) cut short,
so that the card finishes each launch before the host issues the next:
``local_attention_fused`` over a 64-token prompt (window 4,096; the
tree's default softcap, which the wrappers before the softcap lack) and
``paged_attention_fused`` at a 4-slot decode step over 4 pages a slot
(softcap 50). One
call runs with each piece of the wrapper's host path recorded,
found by the name the wrapper calls it through: the input checks, the
output allocations, getting the current stream, the launch plan, the new
tail (a ``torch.cat`` where the kernel does not write it) and the call
into the kernel's library. Then each piece is timed alone on the
arguments it was given, by the host clock over 5 runs of 1,000 calls with
no synchronise inside (median). The ctypes call alone is timed on the same
library's ``repro_cuda_error_string`` given the launch function's argument
types and the same arguments: the same conversions, and no launch.
``launch_us`` (the library call less the ctypes call) and ``rest_us``
(the whole call less every piece) are differences of medians of noisy
timings: they move by a few microseconds between runs and can come out
negative.

Where SRC has the training route's autograd Functions (``LstmCell``,
``PixconGate``), ``function_route`` holds, at the same two shapes under
``inference_mode`` as the forecast runs, the host time of one call by the
wrapper's direct launch and by the Function's ``apply`` (the same launch),
timed in turns over 7 rounds of 1,000 calls (median).

Prints one JSON line. Host times move up to ~2x between calls and
machines, so two trees are compared only in one call, in turns (parent,
change, change, parent).
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
CALLS = 1000


def patched(patches):
    """A context that sets each (object, name, value) of ``patches``."""
    stack = contextlib.ExitStack()
    for o, n, v in patches:
        stack.enter_context(mock.patch.object(o, n, v))
    return stack


def host_breakdown(ops, call, host_us) -> dict:
    """Where the host time of ``call``, one call of the wrapper in the
    module ``ops`` on fixed inputs, goes, in microseconds."""
    import torch
    names = {"checks": [(ops, "check_activations"), (ops, "check_inputs"),
                        (ops, "_check"), (ops, "_fits")],
             "alloc": [(torch, "empty_like"), (torch, "empty"),
                       (torch.Tensor, "new_empty")],
             "stream": [(torch.cuda, "current_stream"), (ops, "stream_handle")],
             "plan": [(ops, "plan_conv"), (ops, "plan_lstm"), (ops, "plan_ssd"),
                      (ops, "sm_count"), (ops, "grid_of")],
             "new_tail": [(ops, "new_tail")]}
    seen = {label: [] for label in names}
    launches = []
    lib = ops._lib()

    def recorder(calls, fn):
        def rec(*a, **k):
            calls.append((fn, a, k))
            return fn(*a, **k)
        return rec

    class Recording:
        def __getattr__(self, name):
            return recorder(launches, getattr(lib, name))

    patches = [(o, n, recorder(seen[label], getattr(o, n)))
               for label, targets in names.items()
               for o, n in targets if hasattr(o, n)]
    with patched(patches + [(ops, "_lib", Recording)]):
        call()

    def run(calls):
        for fn, a, k in calls:
            fn(*a, **k)
    out = {"call_us": host_us(call)}
    for label, calls in seen.items():
        if calls:
            out[f"{label}_us"] = host_us(lambda: run(calls))
    out["library_call_us"] = host_us(lambda: run(launches))
    fn, args, _ = launches[0]
    noop = type(fn)(("repro_cuda_error_string", lib))
    noop.argtypes, noop.restype = fn.argtypes, ctypes.c_int
    out["ctypes_us"] = host_us(lambda: noop(*args))
    out["launch_us"] = out["library_call_us"] - out["ctypes_us"]
    out["rest_us"] = out["call_us"] - sum(
        v for k, v in out.items() if k not in ("call_us", "ctypes_us", "launch_us"))
    return out


def route_cost(direct, through, host_us, rounds: int = 7) -> dict:
    """Host time of one call of ``direct`` and of ``through`` under
    ``inference_mode``, in microseconds, timed in turns (median)."""
    import torch
    runs = ([], [])
    with torch.inference_mode():
        for _ in range(rounds):
            for r, fn in zip(runs, (direct, through)):
                r.append(host_us(fn, calls=CALLS, repeats=1))
    d, f = (sorted(r)[len(r) // 2] for r in runs)
    return {"direct_us": d, "function_us": f, "difference_us": f - d,
            "direct_runs_us": runs[0], "function_runs_us": runs[1]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wrapper_host_time: no CUDA device", file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"wrapper_host_time: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))              # chip_smoke's timing helpers
    sys.path.insert(0, str(src))
    from chip_smoke import (conv_args, host_us, lstm_inputs, paged_inputs,
                            pixcon_inputs, ssd_inputs)
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.local_attn import ops as local_ops
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    from repro_torch.kernels.paged_attn import ops as paged_ops
    from repro_torch.kernels.pixcon import ops as pixcon_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    def timed(fn):
        return host_us(fn, calls=CALLS)
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(99)
    conv = conv_args(g, dev, torch.bfloat16, 4, 1, 1792, 4, True)
    lstm = lstm_inputs(g, dev, 23, 1, 128, 64)
    pix = pixcon_inputs(g, dev, 23, 1, 30, 64)
    ssd = ssd_inputs(g, dev, torch.bfloat16, 1, 2, 256, 24, 128, 64)
    local = {n: torch.randn(1, 64, h, 256, generator=g).to(dev, torch.bfloat16)
             for n, h in (("q", 8), ("k", 4), ("v", 4))}
    paged = paged_inputs(g, dev, torch.bfloat16, 4, 1, 8, 4, 256, 16, 4,
                         [60, 58, 56, 54])
    out = {"src": str(src), "card": torch.cuda.get_device_name(0),
           "conv1d_mamba2_decode": host_breakdown(
               conv_ops, lambda: conv_ops.causal_conv1d(**conv, activation="silu"),
               timed),
           "lstm_cell_layer0": host_breakdown(
               lstm_ops, lambda: lstm_ops.lstm_cell_fused(**lstm), timed),
           "pixcon_forecast": host_breakdown(
               pixcon_ops, lambda: pixcon_ops.pixcon_gate(**pix), timed),
           "ssd_chunk_mamba2_prefill": host_breakdown(
               ssd_ops, lambda: ssd_ops.ssd_chunk_fused(**ssd), timed),
           "local_attn_gemma2_heads": host_breakdown(
               local_ops, lambda: local_ops.local_attention_fused(
                   **local, window=4096), timed),
           "paged_attn_gemma2_decode": host_breakdown(
               paged_ops, lambda: paged_ops.paged_attention_fused(
                   **paged, softcap=50.0), timed)}
    if hasattr(lstm_ops, "LstmCell"):
        out["function_route"] = {
            "lstm_cell_layer0": route_cost(
                lambda: lstm_ops.lstm_cell_fused(**lstm),
                lambda: lstm_ops.LstmCell.apply(*lstm.values()), host_us),
            "pixcon_forecast": route_cost(
                lambda: pixcon_ops.pixcon_gate(**pix),
                lambda: pixcon_ops.PixconGate.apply(*pix.values(), 1.0, True),
                host_us)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
