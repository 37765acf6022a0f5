#!/usr/bin/env python3
"""Per-block timeline of one SSD-chunk launch, on one NVIDIA GPU.

    python3 scripts/ssd_chunk_timeline.py

Builds a copy of ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` in which
every block records the global timer (ns) and the SM's clock when it
starts and when its last warp ends, and the SM it ran on, into a buffer
the launch is given; launches it at mamba2-130m's 512-token prefill
layer (B=1, nc=2, Q=256, H=24, N=128, P=64) in bf16 and float32, with the
plan ``ops.plan_ssd`` makes, and prints one JSON line: for each dtype the
launch's span (first start to last end) and, by kind of block (y blocks by
query tile, heaviest first, then the state blocks), the number of blocks
and the least, median and largest start, end and duration in us, with the
median duration in SM cycles. It says which blocks set the launch's
length and whether they waited for a place on an SM or ran long.

The copy is built into ``build/`` with the flags of ``kernels/build.py``;
the kernel's arithmetic is the committed one (y and the state are checked
against the plain version before the timing).
"""
from __future__ import annotations

import ctypes
import json
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = "B=1 nc=2 Q=256 H=24 N=128 P=64"  # mamba2-130m's 512-token prefill layer

START = (
    "  unsigned long long g0, c0;\n  unsigned sm;\n"
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));\n'
    '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0));\n'
    '  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
)
# the end: the latest warp to get there (warps that leave early, as a y
# block's second key half does, are done before it), by atomicMax, so no
# barrier is needed
END = (
    "  {\n    unsigned long long g1, c1;\n"
    '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
    '    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1));\n'
    "    unsigned long long* d = p.stamps + 5 * (long)blockIdx.x;\n"
    "    if ((threadIdx.x & 31) == 0) {\n"
    "      atomicMax(d + 1, g1);\n      atomicMax(d + 3, c1);\n    }\n"
    "    if (threadIdx.x == 0) {\n"
    "      d[0] = g0; d[2] = c0; d[4] = sm;\n    }\n  }\n"
)
# the dispatch of each kernel, after which the end stamp goes
DISPATCH = (
    "    f32_state_block(Bm, X, dA, ST, s, w, p.vec != 0, smem_raw);\n",
    "    mma_state_block(Bm, X, dA, ST, s, w, p.vec != 0, smem_raw);\n",
)
PLAN_END = "  int state_first;  // the state blocks take the first block indices\n};"


def stamped_source() -> str:
    """The kernel source with the per-block stamps; raises if the source
    no longer has the lines the stamps go beside."""
    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_chunk.cu").read_text()
    edits = [
        (PLAN_END, "  int state_first;\n  unsigned long long* stamps;\n};"),
        (
            "  const Work w = block_work(p, s);\n",
            START + "  const Work w = block_work(p, s);\n",
        ),
        ("int64_t a[21];", "int64_t a[22];"),
        (
            "  p.state_first = static_cast<int>(a[20]);\n",
            "  p.state_first = static_cast<int>(a[20]);\n"
            "  p.stamps = reinterpret_cast<unsigned long long*>(a[21]);\n",
        ),
    ]
    edits += [(d, d + END) for d in DISPATCH]
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ssd_chunk.cu changed: no {old.strip()!r}")
        src = src.replace(old, new)
    return src


def summary(values) -> list:
    v = sorted(values)
    return [round(v[0], 3), round(v[len(v) // 2], 3), round(v[-1], 3)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_chunk_timeline: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import ssd_inputs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

    out_dir = ROOT / "build" / "ssd_chunk_timeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "ssd_chunk_stamped.cu"
    so = out_dir / "libssd_chunk_stamped.so"
    cu.write_text(stamped_source())
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC)]
    subprocess.run([*cmd, "-o", str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ssd_chunk_launch.argtypes = [ctypes.c_char_p]
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    B, nc, Q, H, N, P = 1, 2, 256, 24, 128, 64
    res = {"card": torch.cuda.get_device_name(0), "shape": SHAPE}
    for dtype in (torch.bfloat16, torch.float32):
        a = ssd_inputs(g, dev, dtype, B, nc, Q, H, N, P)
        y = torch.empty_like(a["xdt"])
        st = torch.empty((B, nc, H, P, N), device=dev)
        p = ops.plan_ssd(B * nc, Q, H, N, P, a["xdt"].element_size(), True)
        stamps = torch.zeros(p.blocks * 5, dtype=torch.int64, device=dev)
        ptrs = [a[k].data_ptr() for k in ("Cc", "Bc", "xdt", "dA_cs")]
        ptrs += [y.data_ptr(), st.data_ptr()]
        shape = [B * nc, Q, H, N, P, int(dtype == torch.bfloat16), 0]
        stream = torch.cuda.current_stream().cuda_stream
        args = struct.pack("22q", *ptrs, *shape, stream, *p, stamps.data_ptr())
        for i in range(20):  # warm, then one read
            if i == 19:
                torch.cuda.synchronize()
                stamps.zero_()
            if lib.ssd_chunk_launch(args):
                raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        ry, rst = ssd_chunk_ref(**a)
        if dtype == torch.bfloat16:
            tol = 2e-2 + 2**-7 * ry.float().abs()
        else:
            tol = torch.full_like(ry, 1e-5)
        y_ok = bool(((y.float() - ry.float()).abs() <= tol).all())
        if not (y_ok and float((st - rst).abs().max()) <= 1e-5):
            raise RuntimeError(f"{dtype}: the stamped kernel disagrees")
        d = stamps.view(-1, 5).cpu().tolist()
        t0 = min(r[0] for r in d)
        ns = p.blocks - p.y_blocks
        kinds: dict = {}
        for i, r in enumerate(d):
            b = (i + p.y_blocks if i < ns else i - ns) if p.state_first else i
            tile = p.qtiles - 1 - b // (B * nc * H)
            kind = f"y tile {tile}" if b < p.y_blocks else "state"
            kinds.setdefault(kind, []).append(r)
        sms = [r[4] for r in d]
        row = {
            "span_us": round((max(r[1] for r in d) - t0) / 1e3, 3),
            "blocks": p.blocks,
            "state_first": p.state_first,
            "blocks_on_busiest_sm": max(sms.count(sm) for sm in set(sms)),
        }
        for kind, rows in kinds.items():
            cycles = sorted(r[3] - r[2] for r in rows)
            row[kind] = {
                "n": len(rows),
                "start_us": summary((r[0] - t0) / 1e3 for r in rows),
                "end_us": summary((r[1] - t0) / 1e3 for r in rows),
                "dur_us": summary((r[1] - r[0]) / 1e3 for r in rows),
                "cycles_median": cycles[len(cycles) // 2],
            }
        res[str(dtype).split(".")[-1]] = row
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
