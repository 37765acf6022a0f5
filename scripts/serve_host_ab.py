#!/usr/bin/env python3
"""One-device serving times of two checkouts on one card, in turns.

    python3 scripts/serve_host_ab.py OTHER_ROOT [--out FILE]

Runs, each in a process of its own that imports the checkout's own
``src`` and ``chip_smoke.py`` and builds its kernels there:

  * phase 5's bf16 served runs: qwen2-1.5b at full width and depth on
    phase 5's queue (8 x ~512 tokens, 64 new, 4 slots), whole, in
    128-token chunks and with ``spec_k=3`` on the damped weights, after
    phase 5's warm-up;
  * phase 10's bf16 qwen2-1.5b policy runs at half depth (cold, device
    and host prefix hits, defer-only, preempt, the sampled runs and the
    model drafter), after phase 10's warm-up.

The order is OTHER_ROOT (A), this checkout (B), B, A for both; between
them B's phase 5 runs twice with ``torch.inference_mode`` replaced by
``torch.no_grad`` in the whole process (``no_grad``). Each run's tok/s,
decode tok/s and TTFT p50/p99 (host clocks) are printed, with the card's
name and power limit, as one JSON line (and written to ``--out``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("tok_per_s", "decode_tok_per_s", "ttft_p50_s", "ttft_p99_s",
        "wall_s")


def phase5(cs, dev) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config("qwen2-1.5b")
    p32 = tfm.init(cfg, torch.Generator(device=dev).manual_seed(cs.LM_SEED))
    pbf = tfm.cast_params(p32, torch.bfloat16, dev)
    del p32
    reqs = lambda: cs.requests_of(cfg.vocab_size, cs.LM_LENS, cs.LM_GEN)
    cs.serve_once(cfg, dev, pbf, torch.bfloat16,
                  {"prefill_chunk": cs.LM_CHUNK},
                  cs.requests_of(cfg.vocab_size, cs.LM_LENS[:2], 4))
    out = {}
    for name, mode in (("whole", {}),
                       ("chunked", {"prefill_chunk": cs.LM_CHUNK}),
                       ("spec", {"spec_k": cs.LM_SPEC_K})):
        r = cs.serve_once(cfg, dev, cs.damped(cfg, pbf) if name == "spec"
                          else pbf, torch.bfloat16, mode, reqs())
        cs.check_tokens(cfg, name, r, reqs())
        out[name] = {k: r[k] for k in KEYS}
    return out


def phase10(cs, dev) -> dict:
    import torch
    from repro_torch.configs import get_config
    arch, tag = "qwen2-1.5b", "bf16"
    case = cs.POLICY_CASES[(arch, tag)]
    full = get_config(arch)
    cfg = full.replace(num_layers=cs.POL_DEPTH.get(arch, full.num_layers))
    host_bytes = cs.POL_HOST_BYTES * cs.page_bytes(cfg) // cs.page_bytes(full)
    params = cs.init_params(cfg, dev, torch.bfloat16)
    warm = cs.requests_of(cfg.vocab_size, [300, 290, 280], 4)
    cs.serve_once(cfg, dev, params, torch.bfloat16, dict(
        prefill_chunk=cs.LM_CHUNK, prefix_cache=True, preempt=True,
        num_pages=cs.request_pages(warm), host_cache_bytes=host_bytes), warm)
    runs = cs.policy_runs(cfg, dev, params, cs.damped(cfg, params),
                          torch.bfloat16, case, checked=False,
                          host_bytes=host_bytes)
    cs.policy_checks(arch, runs, full=True, exact=False)
    return {name: {k: r[k] for k in KEYS} for name, r in runs.items()}


def worker(root: Path, phases: list, no_grad: bool) -> dict:
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(root / "build/inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build/triton"))
    import torch
    if no_grad:     # before the port is imported: its decorators too
        torch.inference_mode = lambda mode=True: torch.no_grad()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    build.build()
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for p in phases:
        t0 = time.perf_counter()
        out[f"phase{p}"] = {"phase5": phase5, "phase10": phase10}[
            f"phase{p}"](cs, dev)
        out[f"phase{p}_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root (A)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phases", default="5,10", help=argparse.SUPPRESS)
    ap.add_argument("--no-grad", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [int(p) for p in args.phases.split(",")]
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve(), phases,
                                args.no_grad)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_host_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.other:
        ap.error("OTHER_ROOT is required")
    a, b = Path(args.other).resolve(), ROOT
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    plan = [("A", a, "5,10", False), ("B", b, "5,10", False),
            ("B no_grad", b, "5", True), ("B no_grad", b, "5", True),
            ("B", b, "5,10", False), ("A", a, "5,10", False)]
    runs = []
    for tag, root, ph, ng in plan:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root), "--phases", ph] + (["--no-grad"] if ng else [])
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
            print(f"serve_host_ab: {tag} ({root}) failed", file=sys.stderr)
            return 1
        res = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append({"tree": tag, "root": str(root),
                     "process_s": time.perf_counter() - t0, **res})
        print(f"{tag}: " + json.dumps(res), flush=True)
    line = json.dumps({"card": smi, "runs": runs})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(smi)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
