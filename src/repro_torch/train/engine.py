"""The training engine, on one device or on a mesh.

One :class:`Engine` owns what a training loop needs around a
``loss_fn(params, batch) -> (loss (R,), metrics)``:

  * gradient accumulation over ``accum_steps`` microbatches: a Python loop
    over slices of the per-replica batch axis (the reference scans them),
    gradients and metrics summed in float32 and averaged;
  * the stacked/IP-D mode (paper Fig. 2a): every leaf of the params and
    batch carries a leading watershed axis R, the port's written-out form
    of the reference's ``jax.vmap`` of the step; single mode is R=1, with
    the batch's axis added by ``place_batch`` and the metrics returned
    without it;
  * the optimizer update, held-out evaluation and checkpoint save/restore
    of the full state.

``mesh=None`` runs on one device with plain tensors. With a
``DeviceMesh`` (``launch/mesh.py``), the reference's rule table
(``distributed/sharding.py``) places the state and the batches as
DTensors: params and moments by their logical axes (the ``fsdp=True``
variant when ``tc.fsdp`` is set), the optimizer's per-replica step count
by ``batch`` (stacked) or replicated, each batch input by its axes (the
watershed axis on ("pod", "data") in stacked mode, the minibatch axis in
single mode and for LMs). The step runs under ``logical_sharding`` (the
models' ``constrain`` calls redistribute) and ``implicit_replication``
(plain tensors such as position tables count as replicated); each
gradient is redistributed to its param's placements before the update,
which is where the data-parallel reduction happens; the kernels run on
local shards through ``local_map``. Accumulation slices each rank's
block of the minibatch, whose rows ``place_batch`` has ordered so that
the ranks' slices i make up the reference's contiguous microbatch i. ``save`` gathers the state to the npz the
one-device engine writes (rank 0 writes it), ``restore`` distributes it
again. In stacked mode at a watershed axis the data axes divide and a
model axis of 1, a step moves nothing across ranks.
``donate`` (the default, as the reference's) is the port's form of the
reference's donated step: the step updates the params, the optimizer
moments and its own gradients in their tensors, so the state passed in
becomes the state returned and the caller must not reuse the old one
(``init_state`` takes ownership of the params it is given). At
recurrentgemma-2b's 2.9 B params, float32 params, gradients and two
AdamW moments take 46.3 GB; an out-of-place update would add another
34.7 GB while the old state lives. ``donate=False`` runs the same
operations on copies: the same values, and the old state stays valid.

``Engine.for_domst`` binds the Dom-ST path; on the card its forward runs
the Pix-Con and LSTM-step kernels and its backward runs autograd through
their plain versions (``kernels/*/ops.py``). ``Engine.for_lm`` binds LM
training (``transformer.lm_loss``): the per-layer param tree is kept flat,
keyed by '/'-joined paths (``convert.flatten``) with a leading replica
axis of 1, and rebuilt as views inside the loss; token batches stay
integer, and the front ends' ``frames`` and ``patches`` stay float32
(``transformer.embed_inputs`` casts them, as the reference does). On the
card the causal conv1d, SSD-chunk and local-attention kernels run the
forward, and autograd through their plain versions the backward.

While ``obs.profiler.active()`` the step records spans into the engine's
registry (``registry=``, the process-wide one by default):
``engine.step`` around the whole step, ``engine.forward`` around each
microbatch's loss, ``engine.backward`` around its gradient (with block
remat, the recompute too) and their placement, ``engine.optimizer``
around the update and ``engine.eval_step`` around an evaluation, each as
host seconds ``<name>_s`` and on the card device seconds
``<name>_device_s``; and the counters ``engine.steps`` and
``engine.microbatches``. Nothing in a step waits for the device for
them, and with tracing off they record nothing.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.convert import flatten, unflatten
from repro_torch.core import domst
from repro_torch.device import as_f32, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.obs import profiler
from repro_torch.obs import registry as obs_registry
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizer import Tree
from repro_torch.train.state import TrainState, new_rng, new_train_state

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Tree, Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _narrow1(v: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Microbatch ``i`` of ``accum`` along axis 1. A DTensor sharded there
    is cut in each rank's own block, so nothing moves: ``place_batch``
    has ordered its rows (``_microbatch_rows``) so that the ranks' slices
    i, in rank order, are the whole axis's contiguous slice i."""
    if isinstance(v, shd.DTensor) and shd.Shard(1) in v.placements:
        loc = v.to_local()
        mb = loc.shape[1] // accum
        shape = list(v.shape)
        shape[1] //= accum
        return shd.DTensor.from_local(
            loc.narrow(1, i * mb, mb).contiguous(), v.device_mesh,
            v.placements, run_check=False, shape=torch.Size(shape),
            stride=tuple(int(torch.Size(shape)[j + 1:].numel())
                         for j in range(len(shape))))
    mb = v.shape[1] // accum
    return v.narrow(1, i * mb, mb).contiguous()


def _microbatch_rows(t: torch.Tensor, accum: int, ways: int) -> torch.Tensor:
    """``t``'s rows along axis 1 reordered for ``ways`` even blocks of
    that axis, each cut into ``accum`` contiguous slices: slice i of every
    block, in block order, holds the whole axis's contiguous microbatch
    i. Each microbatch's loss is a mean over its own rows (or its own
    masked frames), so the rows of a microbatch are those of the
    reference's, not any equal share."""
    s = t.shape
    return t.reshape(s[0], accum, ways, s[1] // (accum * ways), *s[2:]) \
        .transpose(1, 2).reshape(s)


def _microbatches(batch: Batch, accum: int) -> List[Batch]:
    """``batch`` cut into ``accum`` contiguous slices along the per-replica
    batch axis (axis 1)."""
    return [{k: _narrow1(v, i, accum) for k, v in batch.items()}
            for i in range(accum)]


def _no_span(name: str):
    return nullcontext()


def accumulate_grads(loss_fn: LossFn, params: Tree, batch: Batch, accum: int,
                     loss_placements=(), *, span=_no_span
                     ) -> Tuple[Tree, torch.Tensor, Dict]:
    """(grads, loss (R,), metrics) for one macrostep of ``loss_fn``.

    The gradient is that of ``loss.sum()`` over the replicas, which share
    nothing. ``accum > 1`` splits the per-replica batch axis into
    microbatches; grads, losses and metrics accumulate in float32 and are
    averaged. The caller checks that the axis divides. On a mesh the loss
    is first redistributed to ``loss_placements`` (the replica axis's),
    and each gradient to its param's placements. ``span(name)`` opens
    the context each microbatch's ``engine.forward`` and
    ``engine.backward`` run in (the engine's profiler spans).
    """
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    tree = dict(zip(names, leaves))

    def value_and_grad(b: Batch):
        with span("engine.forward"):
            loss, mets = loss_fn(tree, b)
        with span("engine.backward"):
            if shd.is_distributed(loss):
                # the gradient of loss.sum(), seeded per replica so that
                # the loss needs no reduction over the replica axis first
                loss = shd.to_placements(loss, loss_placements)
                grads = torch.autograd.grad(loss, leaves,
                                            torch.ones_like(loss),
                                            allow_unused=True)
            else:
                grads = torch.autograd.grad(loss.sum(), leaves,
                                            allow_unused=True)
            grads = [torch.zeros_like(p) if g is None
                     else shd.to_placements(g, getattr(p, "placements", ()))
                     for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads

    if accum == 1:
        loss, mets, grads = value_and_grad(batch)
        return dict(zip(names, grads)), loss, mets
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    lsum, msum = 0.0, None
    for b in _microbatches(batch, accum):
        loss, mets, grads = value_and_grad(b)
        for a, g in zip(gsum, grads):
            a.add_(g.float())
        del grads
        lsum = lsum + loss.float()
        msum = {k: (0.0 if msum is None else msum[k]) + v.float()
                for k, v in mets.items()}
    return ({k: g.div_(accum) for k, g in zip(names, gsum)}, lsum / accum,
            {k: m / accum for k, m in msum.items()})


def lm_batch_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of each LM training input with the engine's replica
    axis of 1 in front: the reference's ``launch/steps.py::batch_axes`` of
    a training shape."""
    seq2 = ("batch", "seq")
    if cfg.family == "audio":
        axes = {"frames": ("batch", "seq", None), "targets": seq2,
                "loss_mask": seq2}
    elif cfg.family == "vlm":
        axes = {"patches": ("batch", "seq", None), "tokens": seq2,
                "targets": seq2}
    else:
        axes = {"tokens": seq2, "targets": seq2, "loss_mask": seq2}
    return {k: (None,) + v for k, v in axes.items()}


def host_example(state: TrainState) -> TrainState:
    """Empty CPU tensors of ``state``'s full shapes and dtypes: the example
    a checkpoint is read into before it is distributed."""
    def ex(t):
        return torch.empty(tuple(t.shape), dtype=t.dtype)
    opt = state.opt_state
    return TrainState(
        params={k: ex(v) for k, v in state.params.items()},
        opt_state=opt._replace(step=ex(opt.step),
                               mu={k: ex(v) for k, v in opt.mu.items()},
                               nu={k: ex(v) for k, v in opt.nu.items()}),
        step=ex(state.step), rng=state.rng.cpu())


def _place(v: Any, device: torch.device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if t.is_floating_point():
        return as_f32(t, device)
    return t.to(device=device).contiguous()


class Engine:
    """Training step factory on one device (``device`` defaults to the
    card and raises without one) or on ``mesh``, whose device type and
    this rank's device it then takes."""

    def __init__(self, loss_fn: LossFn, tc: TrainConfig, *,
                 stacked: bool = False,
                 accum_steps: Optional[int] = None,
                 donate: bool = True,
                 device: str | torch.device = "cuda",
                 eval_fn: Optional[Callable[[Tree, Batch], Dict]] = None,
                 cfg: Optional[ModelConfig] = None,
                 mesh=None, param_axes: Optional[Dict[str, tuple]] = None,
                 batch_axes: Optional[Dict[str, tuple]] = None,
                 registry: Optional[obs_registry.MetricRegistry] = None):
        """``cfg``: an LM's config (``for_lm``), whose per-layer tree the
        params are kept flat for; None for Dom-ST's flat params.
        ``param_axes`` and ``batch_axes`` (the logical axes of each flat
        param and batch input, replica axis first) are read on a mesh.
        ``registry``: where the step's spans record (and the loader's)."""
        self.registry = (registry if registry is not None
                         else obs_registry.default())
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.tc = tc
        self.cfg = cfg
        self.accum = int(accum_steps) if accum_steps else max(tc.grad_accum, 1)
        self.stacked = stacked
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = resolve_device(
                torch.device("cuda", torch.cuda.current_device())
                if mesh.device_type == "cuda" else mesh.device_type)
            self.param_axes = param_axes
            self.batch_axes = batch_axes
            self.rules = shd.make_rules(cfg, mesh=mesh)
            self.param_rules = (shd.make_rules(cfg, mesh=mesh, fsdp=True)
                                if tc.fsdp else self.rules)
            if tc.fsdp:
                self.loss_fn = self._gathering(loss_fn)
                self.eval_fn = eval_fn and self._gathering(eval_fn)
        self._opt_update = make_optimizer(tc, in_place=donate)[1]

    @classmethod
    def for_domst(cls, cfg: ModelConfig, tc: TrainConfig, *,
                  stacked: bool = False, accum_steps: Optional[int] = None,
                  donate: bool = True, device: str | torch.device = "cuda",
                  ops: domst.KernelOps = domst.KERNELS,
                  mesh=None, registry=None) -> "Engine":
        """Dom-ST flood engine (sequential or stacked/IP-D). ``ops=PLAIN``
        serves only to hold the kernels' run against the plain one."""
        axes = (domst.stacked_param_specs(cfg) if stacked else
                {k: (None,) + v for k, v in domst.param_specs(cfg).items()})
        return cls(lambda p, b: domst.loss_fn(p, cfg, b, ops), tc,
                   stacked=stacked, accum_steps=accum_steps, donate=donate,
                   device=device,
                   eval_fn=lambda p, b: domst.eval_metrics(p, cfg, b, ops),
                   mesh=mesh, param_axes=axes,
                   batch_axes=domst.batch_specs(stacked), registry=registry)

    @classmethod
    def for_lm(cls, cfg: ModelConfig, tc: TrainConfig, *,
               accum_steps: Optional[int] = None, donate: bool = True,
               device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.bfloat16,
               ops: tfm.KernelOps = tfm.KERNELS, mesh=None,
               registry=None) -> "Engine":
        """LM engine for any LM config: the loss is
        ``transformer.lm_loss`` in ``dtype`` activations, with block remat
        unless ``tc.remat`` is ``"none"``; ``eval_fn`` returns the loss and
        its metrics. ``ops=transformer.PLAIN`` serves only to hold the
        kernels' run against the plain one."""
        remat = tc.remat != "none"
        like = tfm.model_params(cfg, lambda *a: None)

        def lm(p, b):
            tree = unflatten({k: v.squeeze(0) for k, v in p.items()}, like)
            loss, mets = tfm.lm_loss(tree, cfg, {k: v[0] for k, v in
                                                 b.items()},
                                     dtype=dtype, remat=remat, ops=ops)
            return loss[None], {k: v[None] for k, v in mets.items()}

        def lm_eval(p, b):
            loss, mets = lm(p, b)
            return {"loss": loss, **mets}

        return cls(lm, tc, accum_steps=accum_steps, donate=donate,
                   device=device, eval_fn=lm_eval, cfg=cfg, mesh=mesh,
                   param_axes=tfm.flat_param_specs(cfg),
                   batch_axes=lm_batch_axes(cfg), registry=registry)

    # -- state lifecycle ---------------------------------------------------
    def init_state(self, params: Tree) -> TrainState:
        """Fresh TrainState around ``params`` (leading replica axis; R=1 in
        single mode; an LM's per-layer tree as ``transformer.init`` or
        ``convert.params_from_jax`` gives it), placed on the device as
        contiguous float32, or on the mesh by the rules (every rank passes
        the same full values and keeps its block). The state takes
        ownership of ``params``: a donating engine updates the tensors it
        shares with them."""
        if self.cfg is not None:
            params = {k: v[None] for k, v in flatten(params).items()}
        if self.mesh is not None:
            return self._placed(new_train_state(
                {k: torch.as_tensor(np.asarray(v)) if not isinstance(
                    v, torch.Tensor) else v for k, v in params.items()},
                self.tc, stacked=self.stacked))
        params = {k: as_f32(v, self.device) for k, v in params.items()}
        return new_train_state(params, self.tc, stacked=self.stacked)

    def wrap(self, params: Tree, opt_state) -> TrainState:
        """Adopt caller-owned ``params`` and ``opt_state`` (from
        ``make_optimizer(tc)[0](params)``) into a TrainState: the shim under
        the seed ``step(params, opt_state, batch)`` signature
        (``domst.make_train_step``). Such engines run with
        ``donate=False``, so the caller's tensors are never written. The
        step counter starts at 0 and the rng leaf is drawn from
        ``tc.seed``: these callers own no rng stream. On a mesh, full
        tensors are distributed by the rules and DTensors (a previous
        step's output) are taken as they are."""
        first = next(iter(params.values()))
        state = TrainState(params, opt_state,
                           torch.zeros((), dtype=torch.int32,
                                       device=self.device),
                           new_rng(self.tc, first.shape[0], self.stacked))
        if self.mesh is not None and not shd.is_distributed(first):
            return self._placed(state)
        return state

    # -- placement on the mesh ---------------------------------------------
    def _placed(self, state: TrainState) -> TrainState:
        """A state of full tensors (any device) distributed by the rules."""
        def tree(t):
            return shd.distribute_tree(t, self.param_axes, self.mesh,
                                       self.param_rules, device=self.device)
        opt = state.opt_state
        step_axes = ("batch",) if self.stacked else (None,)
        return TrainState(
            params=tree(state.params),
            opt_state=opt._replace(
                step=shd.distribute(opt.step, self.mesh, shd.resolve(
                    step_axes, opt.step.shape, self.mesh, self.rules),
                    self.device),
                mu=tree(opt.mu), nu=tree(opt.nu) if opt.nu else opt.nu),
            step=state.step.to(self.device), rng=state.rng)

    def host_state(self, state: TrainState) -> TrainState:
        """The state's full values as CPU tensors (a collective on a mesh:
        every rank calls it)."""
        def full(t):
            return torch.from_numpy(shd.full_host(t))
        opt = state.opt_state
        return TrainState(
            params={k: full(v) for k, v in state.params.items()},
            opt_state=opt._replace(
                step=full(opt.step),
                mu={k: full(v) for k, v in opt.mu.items()},
                nu={k: full(v) for k, v in opt.nu.items()}),
            step=full(state.step), rng=state.rng.cpu())

    def params_tree(self, state: TrainState) -> Tree:
        """An LM state's params as the per-layer tree (views without the
        replica axis): what ``transformer`` and the serving engine take."""
        return unflatten({k: v[0] for k, v in state.params.items()},
                         tfm.model_params(self.cfg, lambda *a: None))

    def save(self, path: str, state: TrainState) -> None:
        """The state to ``path``; on a mesh gathered to the same file the
        one-device engine writes, by rank 0."""
        if self.mesh is None:
            ckpt.save(path, state, self.cfg)
            return
        host = self.host_state(state)
        if torch.distributed.get_rank() == 0:
            ckpt.save(path, host, self.cfg)
        torch.distributed.barrier()

    def restore(self, path: str, example: TrainState) -> TrainState:
        if self.mesh is None:
            return ckpt.restore(path, example, self.cfg)
        ex = host_example(example)
        return self._placed(ckpt.restore(path, ex, self.cfg))

    def place_batch(self, batch: Dict[str, Any]) -> Batch:
        """A host batch as contiguous tensors on the device, float32 but
        for integer leaves (tokens, targets), which keep their dtype
        (``frames``, ``patches`` and ``loss_mask`` are float32), with
        the leading replica axis (added in single mode): the loader's
        placement hook. On a mesh each input becomes a DTensor placed by
        its axes, this rank's block copied to its device; with
        ``accum_steps > 1`` and the minibatch axis split, its rows are
        first ordered by ``_microbatch_rows`` (eval metrics are
        reductions over the rows, which the order does not change)."""
        if self.mesh is not None:
            out = {}
            for k, v in batch.items():
                t = v if isinstance(v, torch.Tensor) \
                    else torch.as_tensor(np.asarray(v))
                t = t if self.stacked else t[None]
                pl = shd.resolve(self.batch_axes[k], t.shape, self.mesh,
                                 self.rules)
                ways = math.prod(self.mesh.size(i) for i, p in enumerate(pl)
                                 if p == shd.Shard(1))
                if self.accum > 1 and ways > 1:
                    if t.shape[1] % (self.accum * ways):
                        raise ValueError(
                            f"{k}: minibatch dim {t.shape[1]} not divisible "
                            f"by accum_steps={self.accum} x {ways} ranks")
                    t = _microbatch_rows(t, self.accum, ways)
                out[k] = shd.distribute(
                    t, self.mesh, pl, self.device,
                    torch.float32 if t.is_floating_point() else None)
            return out
        out = {k: _place(v, self.device) for k, v in batch.items()}
        return out if self.stacked else {k: v[None] for k, v in out.items()}

    def _context(self):
        """The context a step runs in (``sharding.mesh_context``)."""
        return shd.mesh_context(self.mesh, getattr(self, "rules", None))

    def _gathering(self, fn: Callable) -> Callable:
        """``fn`` on the params redistributed from the FSDP placements to
        the activation rules' (the ZeRO-3 all-gather: its backward is the
        reduce-scatter of each gradient back to its param's shard)."""
        def run(params, batch):
            return fn({k: shd.to_placements(v, shd.resolve(
                self.param_axes[k], v.shape, self.mesh, self.rules))
                for k, v in params.items()}, batch)
        return run

    def _loss_placements(self, state: TrainState):
        if self.mesh is None:
            return ()
        return tuple(state.opt_state.step.placements)

    # -- the step ----------------------------------------------------------
    def _unstack(self, mets: Dict) -> Dict:
        return mets if self.stacked else {k: v[0] for k, v in mets.items()}

    def _span(self, name: str):
        return profiler.span(name, self.registry, self.device)

    def step(self, state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One (macro)step on a batch from ``place_batch``: ``(state,
        batch) -> (new state, metrics)``; the per-replica minibatch dim must
        divide ``accum_steps``. A donating engine updates ``state``'s
        tensors: only the returned state may be used after it."""
        with self._span("engine.step"):
            if self.accum > 1:
                mb = next(iter(batch.values())).shape[1]
                if mb % self.accum:
                    raise ValueError(
                        f"minibatch dim {mb} not divisible by "
                        f"accum_steps={self.accum}")
            if profiler.active():
                self.registry.add("engine.steps")
                self.registry.add("engine.microbatches", self.accum)
            with self._context():
                grads, loss, mets = accumulate_grads(
                    self.loss_fn, state.params, batch, self.accum,
                    self._loss_placements(state), span=self._span)
                with self._span("engine.optimizer"):
                    params, opt_state, om = self._opt_update(
                        state.params, grads, state.opt_state)
                return (TrainState(params, opt_state, state.step + 1,
                                   state.rng),
                        self._unstack({**mets, **om, "loss": loss}))

    def eval_step(self, state: TrainState, batch: Batch) -> Dict:
        """Held-out metrics on the live state, no update: per-replica NSE and
        MSE for Dom-ST (scalars in single mode)."""
        if self.eval_fn is None:
            raise ValueError("engine was built without an eval_fn")
        with self._span("engine.eval_step"), torch.no_grad(), \
                self._context():
            return self._unstack(self.eval_fn(state.params, batch))
