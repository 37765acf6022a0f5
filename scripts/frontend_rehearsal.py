#!/usr/bin/env python3
"""CPU rehearsal of ``chip_smoke.py`` phase 13's launch counts.

    PYTHONPATH=src python scripts/frontend_rehearsal.py [--width 256]

Runs phase 13's paths on the CPU at their full depth and a narrow width
(``--width``: d_model, and 16 query heads on 8 of width/16, the FFN 2x),
with every other dimension of the phase kept: internvl2-2b's 24 layers,
its vocab of 92,553 (so the prompts are the card's own draws), 256
patches of 1,024 features, the one wave of 4 requests (512/510/508/506
text tokens, 32 new) on 4 slots with 16-token pages, whole, in 128-token
chunks and with ``spec_k=3`` on the damped weights (the n-gram drafter's
acceptance follows from the token stream, which the damped model makes a
repetition of its last token at any width); and one training step each
of hubert-xlarge and internvl2-2b at full depth. Each kernel the stack
calls runs its plain version under a counter, so the counts are the
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

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data.tokens import TokenSource  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    InferenceEngine, NgramDrafter, Scheduler,
)
from repro_torch.train import Engine  # noqa: E402


class Counted:
    """A kernel's plain version that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def counting_ops() -> tfm.KernelOps:
    return tfm.KernelOps(*(Counted(p) for p in tfm.PLAIN))


def counts(ops: tfm.KernelOps) -> dict:
    return {k: c.calls for k, c in zip(tfm.KernelOps._fields, ops)}


def narrow(arch: str, width: int):
    cfg = get_config(arch)
    return cfg.replace(d_model=width, head_dim=width // cfg.num_heads,
                       d_ff=2 * width)


def serve(cfg, params, mode: dict) -> dict:
    reqs = cs.vlm_requests_of(cfg, cs.VLM_LENS, cs.VLM_GEN)
    ops = counting_ops()
    spec_k = mode.get("spec_k", 0)
    eng = InferenceEngine(cfg, slots=cs.LM_SLOTS,
                          max_len=max(cs.request_len(r) for r in reqs),
                          page_size=16, dtype=torch.float32, device="cpu",
                          prefill_chunk=mode.get("prefill_chunk", 0), ops=ops)
    sched = Scheduler(eng, eng.init_state(params), spec_k=spec_k,
                      drafter=NgramDrafter() if spec_k else None)
    gen = sched.run(reqs)
    st = sched.stats
    return {"launches": counts(ops),
            "tokens": sum(len(g) for g in gen.values()),
            **{k: st[k] for k in ("prefill_chunks", "decode_steps",
                                  "spec_steps", "spec_proposed",
                                  "spec_accepted")}}


def train_step(cfg, batch: int, seq: int) -> dict:
    ops = counting_ops()
    eng = Engine.for_lm(cfg, TrainConfig(remat="block"), device="cpu",
                        dtype=torch.float32, ops=ops)
    state = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(0)))
    eng.step(state, eng.place_batch(TokenSource(cfg, batch, seq).host_batch(0)))
    return counts(ops)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--train-seq", type=int, default=300,
                    help="positions a training row (internvl2: 256 patches "
                         "and the rest text)")
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    cfg = narrow(cs.VLM_ARCH, args.width)
    params = tfm.init(cfg, torch.Generator().manual_seed(cs.LM_SEED))
    modes = {"whole": {}, "chunked": {"prefill_chunk": cs.LM_CHUNK},
             "spec": {"spec_k": cs.LM_SPEC_K}}
    out = {"width": args.width, "layers": cfg.num_layers, "serving": {}}
    for name, mode in modes.items():
        p = cs.damped(cfg, params) if name == "spec" else params
        out["serving"][name] = serve(cfg, p, mode)
    out["training"] = {arch: train_step(narrow(arch, args.width), 1,
                                        args.train_seq)
                       for arch in cs.FE_TRAIN}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
