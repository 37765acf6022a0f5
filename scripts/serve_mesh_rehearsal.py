#!/usr/bin/env python3
"""CPU rehearsal of ``chip_smoke.py`` phases 15 and 16's launch counts.

    PYTHONPATH=src python scripts/serve_mesh_rehearsal.py [--width 384] [--phase 15|16]

Phase 15 (the default): serves phase 15's queue on the CPU at
qwen2-1.5b's full depth and a narrow width (``--width``: d_model, its 12
query heads on 2 KV heads of width/12, the FFN 2x), with every other
dimension of the phase kept: its 28 layers, its vocab (so the prompts
are the card's own draws), the one wave of 4 requests (512/510/508/506
tokens, 32 new) on 4 slots with 16-token pages, whole, in 128-token
chunks and with ``spec_k=3`` on the damped weights (the n-gram drafter's
acceptance follows from the token stream, which the damped model makes a
repetition of its last token at any width); each on one device and
through ``InferenceEngine(mesh=)`` on a 1x1 gloo mesh.

Phase 16: the same wave through mamba2-130m at its full depth (24 SSM
layers, state 128, chunks of 256) and ``--width`` channels, in the three
modes, and through deepseek-moe-16b at its full depth (28 layers, the
first dense; 64 experts top 6 and 2 shared) at ``--width`` channels,
whole; each on one device and on the 1x1 mesh (the MoE layers through
``moe_block_sharded``).

Every kernel's plain version runs under a counter, so its count is the
launches the card's run makes. It prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from frontend_rehearsal import counting_ops, counts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import InferenceEngine, NgramDrafter, Scheduler  # noqa: E402


def serve(cfg, params, mode: dict, mesh) -> dict:
    reqs = cs.requests_of(cfg.vocab_size, cs.STEP_LENS, 32)
    ops = counting_ops()
    spec_k = mode.get("spec_k", 0)
    eng = InferenceEngine(cfg, mesh=mesh, slots=cs.LM_SLOTS,
                          max_len=max(cs.request_len(r) for r in reqs),
                          page_size=16, dtype=torch.float32, device="cpu",
                          prefill_chunk=mode.get("prefill_chunk", 0), ops=ops)
    sched = Scheduler(eng, eng.init_state(params), spec_k=spec_k,
                      drafter=NgramDrafter() if spec_k else None)
    gen = sched.run(reqs)
    st = sched.stats
    return {"launches": counts(ops), "gen": {k: list(map(int, v))
                                             for k, v in gen.items()},
            **{k: st[k] for k in ("prefill_chunks", "decode_steps",
                                  "spec_steps", "spec_proposed",
                                  "spec_accepted")}}


def narrow(arch: str, width: int):
    """``arch`` at ``width`` channels, its depth, vocab and layer kinds
    kept (an SSM's head count follows its inner width; a MoE's experts
    and top-k are kept, each expert 2x the width)."""
    cfg = get_config(arch)
    if cfg.ssm is not None:
        return cfg.replace(d_model=width)
    cfg = cfg.replace(d_model=width, head_dim=width // cfg.num_heads,
                      d_ff=2 * width)
    if cfg.moe is not None:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, d_ff_expert=2 * width, d_ff_shared=2 * width))
    return cfg


def rehearse(cfg, modes: dict, mesh) -> dict:
    params = tfm.init(cfg, torch.Generator().manual_seed(cs.LM_SEED))
    out = {}
    for name, mode in modes.items():
        p = cs.damped(cfg, params) if name == "spec" else params
        one, on_mesh = serve(cfg, p, mode, None), serve(cfg, p, mode, mesh)
        if one["gen"] != on_mesh["gen"]:
            raise SystemExit(f"{cfg.name} {name}: the mesh's streams differ")
        out[name] = {**{k: v for k, v in one.items() if k != "gen"},
                     "mesh_launches": on_mesh["launches"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--phase", type=int, choices=(15, 16), default=15)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    modes = {"whole": {}, "chunked": {"prefill_chunk": cs.LM_CHUNK},
             "spec": {"spec_k": cs.LM_SPEC_K}}
    mesh = make_host_mesh("cpu")
    if args.phase == 15:
        cfg = narrow(cs.MESH_SERVE_ARCH, args.width)
        out = {"width": args.width, "layers": cfg.num_layers,
               "serving": rehearse(cfg, modes, mesh)}
    else:
        out = {"width": args.width, "serving": {}}
        for arch, names in cs.MESH_ARCHS.items():
            cfg = narrow(arch, args.width)
            out["serving"][arch] = rehearse(
                cfg, {n: modes[n] for n in names}, mesh)
            out["serving"][arch]["layers"] = cfg.num_layers
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
