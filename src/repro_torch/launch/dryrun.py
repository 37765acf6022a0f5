"""The production-mesh dry run: the port of ``repro/launch/dryrun.py``.

For every (architecture x input shape) of ``matrix()`` (the reference's
32 pairs, with its documented skips) on the (16, 16) ("data", "model")
mesh and the (2, 16, 16) ("pod", "data", "model") mesh, this builds the
step of that shape (``launch/steps.py::build_step``: the LM training
step, a whole prefill, or a decode step on the contiguous cache) on a
world of 256 or 512 ranks and runs rank 0's step ONCE, without devices:

  * the world is ``torch.distributed``'s ``fake`` backend (its store,
    ``FakeStore``, lives in an internal torch module, so its import is
    guarded): every collective returns at once and moves nothing;
  * every tensor is a fake tensor (``FakeTensorMode``): shapes and dtypes
    only, so a 30 B-param model's rank-0 step runs in a few GB of host
    memory.

It records, for rank 0:

  * the bytes of the params, the optimizer moments, the cache and the
    batch, from their local blocks (the analogue of ``memory_analysis``'s
    argument size);
  * the FLOPs of the rank's own ops (``torch.utils.flop_counter``'s
    per-op formulas on the local tensors each DTensor op runs, not on its
    global shapes; DTensor's shape propagation is not counted);
  * the collectives by kind: counts from ``CommDebugMode``, bytes each
    rank sends (the input of each functional collective), the analogue of
    the reference's ``parse_collectives``;
  * the seconds the build and the run took on the host.

These are counts of a program, not times on a device: nothing here runs
on a card. Results go to ``results/dryrun_torch/<arch>__<shape>__<mesh>
.json``.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k [--multipod] [--layers N]
  python -m repro_torch.launch.dryrun --all [--jobs N] [--timeout S]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import TrainConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
COLLECTIVES = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
               "all_to_all_single", "broadcast")


def fake_world(world: int) -> None:
    """A ``fake``-backend process group of ``world`` ranks, this process
    rank 0 (once a process)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"exists; the dry run needs {world}")
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:        # an internal module of torch
        raise RuntimeError("this torch has no fake process-group store "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class RankCounter(TorchDispatchMode):
    """FLOPs and collective bytes of the ops this rank runs on its local
    tensors. A DTensor op is passed on (``NotImplemented``) to DTensor,
    whose local ops come back through this mode; the fake ops of
    DTensor's shape propagation are not counted (``propagating``)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = defaultdict(int)
        self.propagating = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.propagating:
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in COLLECTIVES:
            t = args[0]
            self.bytes[name] += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def _quiet_propagation(counter: RankCounter):
    """Tell ``counter`` when DTensor runs its shape propagation."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        yield
        return

    def wrapped(self, *a, **kw):
        counter.propagating += 1
        try:
            return orig(self, *a, **kw)
        finally:
            counter.propagating -= 1
    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            sequence_parallel: bool = False, tag: str = "",
            fsdp: bool = False, accum: int = 1, serve_bf16: bool = False,
            layers: Optional[int] = None, out_dir: str = RESULTS_DIR) -> dict:
    """Rank 0's step of (arch, shape) on the production mesh; ``layers``
    cuts the depth (widths, mesh and shape stay), for a quick check."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step, local_bytes
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=int(layers))
    mesh_name = "multipod" if multi_pod else "pod"
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    tc = TrainConfig(remat="block", fsdp=fsdp, grad_accum=accum)
    counter = RankCounter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.perf_counter()
        run, inputs, kind = build_step(
            cfg, shape_name, mesh, tc=tc, sequence_parallel=sequence_parallel,
            serve_bf16=serve_bf16, device="cpu")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _quiet_propagation(counter), counter, CommDebugMode() as comm:
            run()
        run_s = time.perf_counter() - t0
    counts = {str(k).split(".")[-1]: int(v)
              for k, v in comm.get_comm_counts().items()}
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "step_kind": kind, "tag": tag, "ranks": int(mesh.size()),
        "mesh_shape": list(mesh.shape), "num_layers": cfg.num_layers,
        "build_s": round(build_s, 2), "run_s": round(run_s, 2),
        "opts": {"fsdp": fsdp, "grad_accum": accum, "serve_bf16": serve_bf16,
                 "sequence_parallel": sequence_parallel},
        "rank0_bytes": {k: local_bytes(v) for k, v in inputs.items()},
        "rank0_flops": counter.flops,
        "collectives": {"counts": counts,
                        "rank0_send_bytes": dict(counter.bytes),
                        "total_count": int(comm.get_total_counts()),
                        "total_send_bytes": int(sum(counter.bytes.values()))},
        "note": "counts of one step's program on rank 0; not device times",
    }
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=2)
    print(f"OK {name}  build={rec['build_s']}s run={rec['run_s']}s "
          f"flops={counter.flops:.3e} collectives={rec['collectives']['total_count']}",
          flush=True)
    return rec


def matrix():
    """The full (arch x shape) baseline list, with the reference's skips:
    no decode shape for an encoder; ``long_500k`` only for sub-quadratic
    decoders (gemma2-2b through its local-only variant)."""
    combos = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for sname, shape in INPUT_SHAPES.items():
            if shape.kind == "decode" and not cfg.supports_decode():
                continue
            if sname == "long_500k":
                if not cfg.supports_decode():
                    continue
                if not cfg.sub_quadratic():
                    if arch == "gemma2-2b":
                        combos.append(("gemma2-2b-localonly", sname))
                    continue
            combos.append((arch, sname))
    return combos


def _run_all(args) -> int:
    jobs = []
    for a, s in matrix():
        for mp in (False, True):
            name = f"{a}__{s}__{'multipod' if mp else 'pod'}"
            if os.path.exists(os.path.join(args.out, name + ".json")):
                print("skip (done)", name, flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--out", args.out]
            if mp:
                cmd.append("--multipod")
            jobs.append((name, cmd))

    def one(job):
        name, cmd = job
        print(">>", " ".join(cmd), flush=True)
        try:
            r = subprocess.run(cmd, timeout=args.timeout,
                               capture_output=True, text=True)
            code, err = r.returncode, r.stderr
        except subprocess.TimeoutExpired:
            code, err = -9, f"timed out after {args.timeout} s"
        if code != 0:
            tail = err.strip().splitlines()[-1:] or ["(no output)"]
            print(f"FAIL {name}: {tail[0]}", flush=True)
            with open(os.path.join(args.out, name + ".fail"), "w") as f:
                f.write(err[-4000:])
        else:
            print(f"done {name}", flush=True)
        return name, code
    os.makedirs(args.out, exist_ok=True)
    with ThreadPoolExecutor(max(args.jobs, 1)) as ex:
        fails = [n for n, c in ex.map(one, jobs) if c != 0]
    print("FAILURES:", fails if fails else "none", flush=True)
    return 1 if fails else 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--seqpar", action="store_true",
                    help="sequence-parallel activation rules")
    ap.add_argument("--tag", default="")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--servebf16", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (widths unchanged)")
    ap.add_argument("--all", action="store_true",
                    help="the whole matrix on both meshes, a subprocess each")
    ap.add_argument("--jobs", type=int, default=1,
                    help="subprocesses at once with --all")
    ap.add_argument("--timeout", type=float, default=2400,
                    help="seconds a subprocess may take with --all")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args()
    if args.list:
        for a, s in matrix():
            print(a, s)
        return
    if args.all:
        sys.exit(_run_all(args))
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all, --list)")
    run_one(args.arch, args.shape, multi_pod=args.multipod,
            sequence_parallel=args.seqpar, tag=args.tag, fsdp=args.fsdp,
            accum=args.accum, serve_bf16=args.servebf16, layers=args.layers,
            out_dir=args.out)


if __name__ == "__main__":
    main()
