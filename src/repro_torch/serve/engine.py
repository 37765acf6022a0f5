"""The inference engine: prefill-insert, chunked insert, fused all-slot
decode and speculative verify over request slots, on one device or on a
mesh.

The port of ``repro/serve/engine.py::InferenceEngine``. It exposes the
surface the scheduler (``serve/scheduler.py``, a copy of the reference's)
calls:

  * attributes ``paged``, ``page_size``, ``num_pages``, ``pages_per_slot``,
    ``slots``, ``max_len``, ``prefill_chunk``, ``has_recurrent_state``;
  * ``assign_pages`` / ``release_pages`` (page-table installs), and the
    policy hooks of the prefix cache (``copy_pages`` for copy-on-write,
    ``get/set_slot_state`` for recurrent snapshots at page boundaries),
    of preemption (``swap_out`` / ``swap_in``) and of the host tier
    (``spill_page`` / ``restore_pages``), whose blobs keep the
    reference's layout (``serve/state.py``);
  * ``set_sampling``: a request's sampling rows (``serve/sampling.py``);
  * ``insert`` (whole-prompt prefill at the exact prompt length, a VLM's
    image patches before the prompt, its ring cache scattered into the
    slot's pages and its recurrent/SSM state into the slot's row),
    ``insert_chunk`` (one prompt chunk written through
    the slot's page row and state row), ``decode`` (one token for every
    slot, ``active`` gating every write) and ``verify`` (one forward over
    each slot's last token plus K drafts, acceptance of the longest prefix
    matching the model's own next tokens, recurrent rows rolled back to
    the last accepted token).

Each step emits the argmax for a greedy slot and a draw under the slot's
own key, folded by absolute stream position, for a sampled one. The
sampler runs only when some slot samples (the host copy of the
temperatures says so): an all-greedy batch is the bare argmax.

The reference's steps are jitted and donated; the port runs them eagerly
under ``torch.no_grad`` and updates
the state's tensors in place, so a hook that restores rows writes into
the existing tensors. Token
outputs come back as numpy arrays, which is where a step waits for the
device. ``from_train_state`` adopts a live LM training state.

``paged=False`` is the reference's contiguous layout, its parity
baseline: a slot-major ring a layer, ``insert`` through ``prefill`` and
``state.scatter_slot``, ``decode`` through ``transformer.decode_step``
(every slot advances; an ``active`` mask is refused, as are ``verify``,
``insert_chunk`` and the page hooks). The port's default is ``paged=True``
(the reference's is False): its callers serve paged.

``mesh=`` (a ``DeviceMesh``, ``launch/mesh.py``; a ``MeshShape`` resolves
the placements without ranks, ``state_shardings``) places the whole state
by the reference's rule table: params by their logical axes, the cache
by ``cache_axes``/``paged_cache_axes`` (a pool's pages on the batch axes,
its offsets or KV heads on "model" by the ``cache_needs_seq_shard``
branch), the per-slot rows and page table on ``("batch",)``; each leaf a
DTensor (``distribute``: every rank passes the same full values and keeps
its block). ``state_shardings`` gives the resolved placements. Inputs are
placed on ``("batch",)`` and each step runs under
``sharding.mesh_context``: the models' ops run as DTensor ops, the
kernels on local blocks (``distributed/kernels.py``), and cache writes on
local blocks (``models/attention.py``). The small per-slot rows (counters,
page table, sampling rows) are read whole at a step's start, the logits
gathered whole, and the sampler runs on whole tensors as on one device;
what it changes is written back block by block. The hooks' host blobs
gather to the host (``take_rows``) in the reference's layout. Without
``mesh=`` the engine is the one-device engine, on plain tensors.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise. ``ops=transformer.PLAIN``
serves only to hold the kernels' run against their plain versions on the
card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import math

import numpy as np
import torch

from repro_torch.checkpoint import restore_lm_params
from repro_torch.configs.base import RECURRENT, SSM, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import PagedKVCache
from repro_torch.obs import profiler
from repro_torch.serve import sampling
from repro_torch.serve.state import (
    InferenceState, cache_leaves, clear_pages, concat_page_rows,
    copy_pool_pages, gather_page_rows, gather_slot_rows,
    inference_state_axes, new_inference_state, new_paged_inference_state,
    paged_inference_state_axes, scatter_page_rows, scatter_slot,
    scatter_slot_rows, select_verified,
)


class InferenceEngine:
    """Prefill/decode/verify steps over request slots, on one device or on
    ``mesh``.

    Paged (the default): a pool of ``num_pages`` pages of ``page_size``
    tokens per attention layer plus per-slot page tables decouple slot
    count from ``max_len``; ``prefill_chunk`` admits long prompts that many
    tokens at a time through :meth:`insert_chunk`, so the scheduler can
    interleave admission with fused decode steps. ``paged=False``: the
    contiguous rings of ``max_len``."""

    def __init__(self, cfg: ModelConfig, *, mesh=None, slots: int = 4,
                 max_len: int = 64, dtype: torch.dtype = torch.bfloat16,
                 paged: bool = True, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 0,
                 device: str | torch.device = "cuda",
                 ops: tfm.KernelOps = tfm.KERNELS):
        if not cfg.supports_decode():
            raise ValueError(f"{cfg.name} has no decode path")
        self.cfg = cfg
        self.mesh = mesh
        kind = getattr(mesh, "device_type", None)   # a MeshShape has none
        if kind is None:
            self.device = resolve_device(device)
        else:
            self.device = resolve_device(
                torch.device("cuda", torch.cuda.current_device())
                if kind == "cuda" else kind)
        if mesh is not None:
            self.rules = shd.make_rules(cfg, mesh=mesh)
        self.ops = ops
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.dtype = dtype
        self.paged = bool(paged)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and not self.paged:
            raise ValueError("prefill_chunk requires the paged cache "
                             "(chunks are written into page tables)")
        if self.paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            self.page_size = int(page_size)
            self.pages_per_slot = -(-self.max_len // self.page_size)
            self.num_pages = int(num_pages) if num_pages \
                else self.slots * self.pages_per_slot
            self._axes = paged_inference_state_axes(cfg)
        else:
            self.page_size = self.pages_per_slot = self.num_pages = None
            self._axes = inference_state_axes(cfg)
        self._leaves = cache_leaves(cfg)
        self._state_shardings = None

    def _require_paged(self, what: str) -> None:
        if not self.paged:
            raise ValueError(f"{what} is a paged-mode operation")

    # -- state lifecycle ---------------------------------------------------
    def init_state(self, params: Any) -> InferenceState:
        """Fresh state around ``params`` (the reference's tree as
        ``convert.params_from_jax`` gives it, or ``transformer.init``'s),
        cast once as the steps use them and placed on the device, or on
        the mesh by the rules (every rank passes the same full params)."""
        params = tfm.cast_params(params, self.dtype, self.device)
        if self.paged:
            state = new_paged_inference_state(
                params, self.cfg, slots=self.slots,
                num_pages=self.num_pages, pages_per_slot=self.pages_per_slot,
                page_size=self.page_size, dtype=self.dtype,
                device=self.device, shards=self._page_shards())
        else:
            state = new_inference_state(
                params, self.cfg, slots=self.slots, max_len=self.max_len,
                dtype=self.dtype, device=self.device)
        if self.mesh is None:
            return state
        return self._place(state, self.state_shardings(state))

    # -- placement on the mesh ---------------------------------------------
    def _page_shards(self) -> int:
        """Blocks the rules cut a pool's page axis into (1 off a mesh)."""
        if self.mesh is None:
            return 1
        a = shd.resolve_axes(("pages",), (self.num_pages,), self.mesh,
                             self.rules)[0]
        sizes = shd.mesh_sizes(self.mesh)
        names = a if isinstance(a, tuple) else (a,) if a else ()
        return math.prod(sizes[n] for n in names)

    def state_shardings(self, state: InferenceState) -> InferenceState:
        """The placements of every leaf of ``state`` from the rule table
        (``None`` for ``temp_host``), resolved once. A pool's page axis is
        resolved at the reference's ``num_pages`` and laid on the storage
        of its shards, each with its sink."""
        if self._state_shardings is None:
            def one(axes, t, pool=False):
                shape = tuple(t.shape)
                if pool:
                    shape = (self.num_pages,) + shape[1:]
                return shd.resolve(axes, shape, self.mesh, self.rules)

            def walk(axes, t):
                if axes is None or t is None:
                    return None
                if shd.is_axes(axes):
                    return one(axes, t)
                if isinstance(t, PagedKVCache):
                    return PagedKVCache(*(one(a, x, True)
                                          for a, x in zip(axes, t)))
                if isinstance(t, dict):
                    return {k: walk(axes[k], t[k]) for k in t}
                if isinstance(t, tuple) and hasattr(t, "_fields"):
                    return type(t)(*(walk(a, x) for a, x in zip(axes, t)))
                if isinstance(t, (list, tuple)):
                    return [walk(a, x) for a, x in zip(axes, t)]
                raise TypeError(type(t))
            self._state_shardings = InferenceState(*(
                walk(a, t) if name != "temp_host" else None
                for name, a, t in zip(InferenceState._fields, self._axes,
                                      state)))
        return self._state_shardings

    def _place(self, state: InferenceState,
               placements: InferenceState) -> InferenceState:
        """``state``'s full tensors as DTensors with ``placements``, each
        rank keeping its block; a leaf that is a DTensor already (params
        adopted from a training engine on this mesh) is redistributed
        device to device, a no-op where its placements are these."""
        def walk(pl, t):
            if pl is None:
                return t
            if shd.is_distributed(t):
                return shd.to_placements(t, pl)
            if isinstance(t, torch.Tensor):
                return shd.distribute(t, self.mesh, pl, self.device)
            if isinstance(t, dict):
                return {k: walk(pl[k], t[k]) for k in t}
            if isinstance(t, tuple) and hasattr(t, "_fields"):
                return type(t)(*(walk(p, x) for p, x in zip(pl, t)))
            return [walk(p, x) for p, x in zip(pl, t)]
        return InferenceState(*(walk(p, t) for p, t in zip(placements, state)))

    def _batch_input(self, t: torch.Tensor) -> torch.Tensor:
        """A step input whose first axis is the slots' (or a request's):
        placed on ``("batch",)`` on the mesh."""
        if self.mesh is None:
            return t
        axes = ("batch",) + (None,) * (t.dim() - 1)
        return shd.distribute(t, self.mesh, shd.resolve(
            axes, t.shape, self.mesh, self.rules), self.device)

    def _context(self):
        """What a step runs in (``sharding.mesh_context``)."""
        return shd.mesh_context(self.mesh, getattr(self, "rules", None))

    @classmethod
    def from_train_state(cls, train_engine, train_state, *, slots: int = 4,
                         max_len: int = 64, dtype: torch.dtype = torch.bfloat16,
                         **kw) -> tuple["InferenceEngine", InferenceState]:
        """Adopt a trained state of an LM ``train.Engine`` (``for_lm``) on
        its device, or on its mesh with its rule table: its flat params as
        the per-layer tree, without the replica axis, cast to the serving
        ``dtype`` (a float32 leaf is shared, not copied). On a mesh the
        params stay on the ranks: a leaf the serving rules place as the
        training ones did is kept as it is, and the FSDP layout
        (``tc.fsdp``: embed over the batch axes) is redistributed device
        to device, an all-gather over those axes; nothing goes through
        the host. The train state must not be stepped afterwards: the
        serving state may share its tensors."""
        eng = cls(train_engine.cfg, mesh=train_engine.mesh, slots=slots,
                  max_len=max_len, dtype=dtype, device=train_engine.device,
                  **kw)
        return eng, eng.init_state(train_engine.params_tree(train_state))

    def restore_params(self, path: str, example_params: Any) -> Any:
        """The ``params`` subtree of a TrainState .npz in the reference's
        layout (its key paths: ``params/blocks/<i>/attn/wq`` stacked over
        the repetitions, ``params/prefix/<j>/...``), restored into
        ``example_params``' layers, shapes, dtypes and device — the CLI
        hand-off without touching optimizer moments. On a mesh each leaf
        is placed as its example (every rank reads the file and keeps its
        block)."""
        got = restore_lm_params(path, example_params, prefix="params")
        if self.mesh is None:
            return got

        def place(g, ex):
            if isinstance(ex, dict):
                return {k: place(g[k], v) for k, v in ex.items()}
            if isinstance(ex, list):
                return [place(a, b) for a, b in zip(g, ex)]
            if shd.is_distributed(ex):
                return shd.distribute(g, self.mesh, ex.placements,
                                      self.device)
            return g
        return place(got, example_params)

    def assign_pages(self, state: InferenceState, slot: int, pages,
                     fresh=None) -> InferenceState:
        """Install ``pages`` (ordered physical page ids from the
        scheduler's free list) as ``slot``'s page row, and reset the
        position metadata of the FRESH ones (default: all of ``pages``) in
        every layer pool: a page recycled from an evicted request must
        never leak stale entries into its new owner's attention mask. A
        prefix-cache admission passes only its newly claimed pages, so the
        shared run's cached entries survive the install."""
        self._require_paged("assign_pages")
        row = np.full((1, self.pages_per_slot), -1, np.int32)
        row[0, :len(pages)] = pages
        shd.put_rows(state.page_table, [slot],
                     torch.from_numpy(row).to(self.device))
        clear = list(pages) if fresh is None else list(fresh)
        if clear:
            clear_pages(state.cache, clear)
        return state

    def release_pages(self, state: InferenceState,
                      slot: int) -> InferenceState:
        """Clear ``slot``'s page row on eviction: a cleared row (-1) sends
        any later write through this slot to the sink page instead of
        into the pages' new owner."""
        self._require_paged("release_pages")
        shd.put_rows(state.page_table, [slot], torch.full(
            (1, self.pages_per_slot), -1, dtype=torch.int32,
            device=self.device))
        return state

    @property
    def has_recurrent_state(self) -> bool:
        """True when the arch keeps slot-major recurrent/SSM state beside
        the paged KV pools (pages hold only attention KV), so a prefix
        hit resumes from a recurrent snapshot at a page boundary."""
        return not self.paged or any(kind in (RECURRENT, SSM)
                                     for kind, _ in tfm.layer_plan(self.cfg))

    # -- policy hooks: prefix cache, preemption, host tier ------------------
    def copy_pages(self, state: InferenceState, src, dst) -> InferenceState:
        """Copy-on-write: clone pool pages ``src`` into ``dst`` in every
        page pool (k, v and pos). The scheduler calls this when an
        admission must write into a page it shares: the write lands in the
        private copy and the shared original stays as its readers saw it."""
        self._require_paged("copy_pages")
        with torch.no_grad():
            copy_pool_pages(state.cache, src, dst)
        return state

    def get_slot_state(self, state: InferenceState, slot: int) -> list:
        """Host snapshot of ``slot``'s recurrent/SSM rows (leaf-aligned,
        ``None`` per paged leaf) — what the prefix cache stores per
        registered page boundary so a later hit can resume mid-prompt."""
        self._require_paged("get_slot_state")
        return gather_slot_rows(state.cache, self._leaves, slot)

    def set_slot_state(self, state: InferenceState, slot: int,
                       rows: list) -> InferenceState:
        """Restore a ``get_slot_state`` snapshot into ``slot`` (any slot),
        in place."""
        self._require_paged("set_slot_state")
        with torch.no_grad():
            scatter_slot_rows(state.cache, self._leaves, slot, rows)
        return state

    def _install_sampling(self, state: InferenceState, slot: int,
                          temp: float, top_k: int, top_p: float, rep: float,
                          key, presence) -> InferenceState:
        """Write one slot's sampling rows (shared by ``set_sampling`` and
        ``swap_in``), in place, and its host temperature."""
        key = np.asarray(key, np.uint32).astype(np.int64)
        with torch.no_grad():
            self._set_row(state.sample_temp, slot, float(temp))
            self._set_row(state.sample_top_k, slot, int(top_k))
            self._set_row(state.sample_top_p, slot, float(top_p))
            self._set_row(state.sample_rep, slot, float(rep))
            for t, v in ((state.sample_key, key),
                         (state.tok_presence, np.asarray(presence, bool))):
                shd.put_rows(t, [slot], torch.from_numpy(v).to(
                    self.device)[None])
        state.temp_host[slot] = temp
        return state

    def set_sampling(self, state: InferenceState, slot: int,
                     params: "sampling.SamplingParams",
                     context=()) -> InferenceState:
        """Install a request's :class:`~repro_torch.serve.sampling.
        SamplingParams` into ``slot``'s rows at admission: parameters, the
        seed's base key, and the repetition-penalty presence row seeded
        with ``context`` (the full prompt — also on a prefix-cache resume,
        so the mask never depends on the resume offset)."""
        params.validate()
        return self._install_sampling(
            state, int(slot), params.temperature, params.top_k,
            params.top_p, params.rep_penalty,
            sampling.base_key(params.seed),
            sampling.presence_row(context, self.cfg.padded_vocab()))

    def swap_out(self, state: InferenceState, slot: int, pages) -> dict:
        """Page-aware preemption, out half: host copies of JUST the
        victim's pool rows (every paged leaf at ``pages``), its slot-major
        recurrent rows, counters and sampling rows. With the host-side
        request (prompt + generated tokens) the blob is the complete
        resume state; the pages and the slot can go to another request at
        once."""
        self._require_paged("swap_out")
        slot = int(slot)

        def row(t):
            return shd.take_rows(t, [slot])[0].cpu()
        return {
            "kv": gather_page_rows(state.cache, self._leaves, pages),
            "rec": gather_slot_rows(state.cache, self._leaves, slot),
            "pos": int(row(state.positions)),
            "last_tok": int(row(state.last_tok)),
            # the base key and the restored position counter reproduce the
            # folds, so a restored request draws the stream it left
            "samp": {
                "temp": float(state.temp_host[slot]),
                "top_k": int(row(state.sample_top_k)),
                "top_p": float(row(state.sample_top_p)),
                "rep": float(row(state.sample_rep)),
                "key": row(state.sample_key).numpy().astype(np.uint32),
                "presence": row(state.tok_presence).numpy(),
            },
        }

    def swap_in(self, state: InferenceState, slot: int, pages,
                blob: dict) -> InferenceState:
        """Restore a ``swap_out`` blob into ``slot`` over freshly claimed
        ``pages`` (same count and order as at swap-out; the physical ids
        may differ — page contents are keyed by absolute position). The
        victim resumes decoding exactly where it was preempted."""
        self._require_paged("swap_in")
        with profiler.annotate("serve.swap_in"):
            state = self.assign_pages(state, slot, pages)
            with torch.no_grad():
                scatter_page_rows(state.cache, self._leaves, pages,
                                  blob["kv"])
                scatter_slot_rows(state.cache, self._leaves, slot,
                                  blob["rec"])
                self._set_row(state.positions, slot, int(blob["pos"]))
                self._set_row(state.last_tok, slot, int(blob["last_tok"]))
            samp = blob["samp"]
            return self._install_sampling(
                state, int(slot), samp["temp"], samp["top_k"],
                samp["top_p"], samp["rep"], samp["key"], samp["presence"])

    def spill_page(self, state: InferenceState, page: int) -> list:
        """Host copy of ONE pool page across every paged leaf — what the
        prefix cache's host tier keeps when it reclaims a cached page
        under pool pressure. The pos leaf travels in the blob, so the
        content stays keyed by absolute stream positions."""
        self._require_paged("spill_page")
        return gather_page_rows(state.cache, self._leaves, [int(page)])

    def restore_pages(self, state: InferenceState, pages,
                      blobs: list) -> InferenceState:
        """Scatter per-page spill blobs (one :meth:`spill_page` blob per
        entry of ``pages``, in order) back into freshly claimed pool
        pages, in one host-to-device copy a leaf: a host-tier hit brings
        the KV back instead of prefilling it again."""
        self._require_paged("restore_pages")
        with profiler.annotate("serve.restore_pages"), torch.no_grad():
            scatter_page_rows(state.cache, self._leaves, pages,
                              concat_page_rows(self._leaves, blobs))
        return state

    # -- the steps ---------------------------------------------------------
    def _set_row(self, t, slot: int, value) -> None:
        """``t[slot] = value`` (a scalar) in place, on local blocks on the
        mesh."""
        shd.put_rows(t, [slot], torch.full((1,), value, dtype=t.dtype,
                                           device=self.device))

    def _inputs(self, inputs: Dict[str, Any],
                patches: bool = True) -> Dict[str, torch.Tensor]:
        """A request's inputs on the device: ``tokens`` int32, and (with
        ``patches``, the vision stub's whole-prompt insert) ``patches``
        float32, which ``embed_inputs`` casts to the activation dtype;
        placed on ``("batch",)`` on the mesh."""
        allowed = {"tokens", "patches"} if patches else {"tokens"}
        if "tokens" not in inputs or set(inputs) - allowed:
            raise ValueError(f"inputs {sorted(inputs)}: this step takes "
                             f"{sorted(allowed)}")
        out = {"tokens": torch.as_tensor(np.asarray(inputs["tokens"]),
                                         dtype=torch.int32,
                                         device=self.device)}
        if "patches" in inputs:
            out["patches"] = torch.as_tensor(
                np.asarray(inputs["patches"]), dtype=torch.float32,
                device=self.device)
        return {k: self._batch_input(v) for k, v in out.items()}

    def _flags(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _draw(self, state: InferenceState, logits: torch.Tensor, rows,
              positions: torch.Tensor, presence: torch.Tensor):
        def pick(t):
            return shd.full(t)[rows]
        return sampling.draw(
            logits, keys=pick(state.sample_key), positions=positions,
            temperature=pick(state.sample_temp),
            top_k=pick(state.sample_top_k), top_p=pick(state.sample_top_p),
            rep_penalty=pick(state.sample_rep), presence=presence)

    def _sample_one(self, state: InferenceState, logits: torch.Tensor,
                    slot: int, pos: int) -> torch.Tensor:
        """First-token emission for one slot (prefill, or a prompt's final
        chunk): the argmax when the slot is greedy, else a draw at
        absolute stream position ``pos``. No presence fold: the prompt's
        was installed at admission, and the emitted token folds in at the
        step that consumes it."""
        logits = shd.full(logits)
        if state.temp_host[slot] <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)  # (1,)
        rows = slice(slot, slot + 1)
        return self._draw(state, logits, rows,
                          torch.full((1,), int(pos), dtype=torch.int32,
                                     device=self.device),
                          shd.full(state.tok_presence)[rows])

    def _sample_all(self, state: InferenceState, logits: torch.Tensor,
                    active: torch.Tensor, positions: torch.Tensor,
                    last_tok: torch.Tensor) -> torch.Tensor:
        """All-slot emission of the fused decode. With every slot greedy
        it is the bare argmax; otherwise each active slot first folds the
        token it just consumed (``last_tok``) into its presence row, then
        draws at position ``positions + 1`` — greedy slots still take the
        raw argmax."""
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)    # (S,)
        if not (state.temp_host > 0).any():
            return greedy
        rows = torch.arange(self.slots, device=self.device)
        presence = shd.full(state.tok_presence)
        pres = presence.clone()
        pres[rows, last_tok.long()] = True
        pres = torch.where(active[:, None], pres, presence)
        toks = self._draw(state, logits, rows, positions + 1, pres)
        shd.assign(state.tok_presence, pres)
        return torch.where(shd.full(state.sample_temp) > 0, toks, greedy)

    def insert(self, state: InferenceState, inputs: Dict[str, Any],
               slot: int):
        """Prefill ONE request (tokens (1, L), exact length, so recurrent
        and SSM state is exact; a VLM's ``patches`` (1, P, Fd) before
        them) into slot ``slot``: in the paged layout its page row must
        already be installed (``assign_pages``) and its KV rings scatter
        into its pages, recurrent/SSM state into its row; in the
        contiguous layout the whole cache goes into the slot's row
        (``scatter_slot``). The slot's position is then P + L, and the
        first token is drawn there. Returns (state, first token (1,))."""
        inputs = self._inputs(inputs)
        slot = int(slot)
        with profiler.annotate("serve.insert"), torch.no_grad(), \
                self._context():
            logits, cache_one = tfm.prefill(state.params, self.cfg, inputs,
                                            max_len=self.max_len,
                                            dtype=self.dtype, ops=self.ops)
            total = inputs["tokens"].shape[1] + (
                inputs["patches"].shape[1] if "patches" in inputs else 0)
            tok = self._sample_one(state, logits, slot, total)
            if self.paged:
                tfm.scatter_prefill_paged(
                    self.cfg, state.cache, cache_one,
                    shd.full(state.page_table)[slot], slot)
            else:
                scatter_slot(state.cache, cache_one, slot)
            self._set_row(state.positions, slot, total)
            shd.put_rows(state.last_tok, [slot], tok)
        return state, tok.cpu().numpy()

    def insert_chunk(self, state: InferenceState, inputs: Dict[str, Any],
                     slot: int, pos_start: int):
        """Insert ONE prompt chunk (tokens (1, C); never patches: the
        scheduler admits a request with patches whole) starting at absolute
        position ``pos_start`` into slot ``slot``'s pages and state row.
        Returns (state, token (1,)), meaningful only for a prompt's final
        chunk, where ``pos_start + C`` is the position a whole-prompt
        insert would draw at: the draw does not depend on chunking."""
        if not self.paged:
            raise ValueError("insert_chunk requires the paged cache")
        inputs = self._inputs(inputs, patches=False)
        slot = int(slot)
        with profiler.annotate("serve.insert_chunk"), torch.no_grad(), \
                self._context():
            logits, _ = tfm.prefill_chunk(
                state.params, self.cfg, inputs, state.cache,
                shd.full(state.page_table)[slot], slot, int(pos_start),
                dtype=self.dtype, ops=self.ops)
            end = int(pos_start) + inputs["tokens"].shape[1]
            tok = self._sample_one(state, logits, slot, end)
            self._set_row(state.positions, slot, end)
            shd.put_rows(state.last_tok, [slot], tok)
        return state, tok.cpu().numpy()

    def decode(self, state: InferenceState, active=None):
        """One decode step over ALL slots: each active slot's last token
        advances its own position counter; inactive slots neither touch
        the page pool nor advance their position, recurrent state or
        presence. Returns (state, tokens (slots,)); inactive slots' tokens
        are garbage the scheduler ignores. The contiguous layout advances
        every slot and refuses ``active``."""
        if not self.paged and active is not None:
            raise ValueError("active masks are a paged-mode feature; the "
                             "contiguous decode advances every slot")
        if active is None:
            active = np.ones((self.slots,), bool)
        act = self._flags(active).bool()
        with profiler.annotate("serve.decode"), torch.no_grad(), \
                self._context():
            positions = shd.full(state.positions)
            last_tok = shd.full(state.last_tok)
            tokens = {"tokens": self._batch_input(last_tok[:, None])}
            if self.paged:
                logits, _ = tfm.decode_step_paged(
                    state.params, self.cfg, tokens, state.cache, positions,
                    shd.full(state.page_table), act, dtype=self.dtype,
                    ops=self.ops)
            else:
                logits, _ = tfm.decode_step(
                    state.params, self.cfg, tokens, state.cache, positions,
                    dtype=self.dtype, ops=self.ops)
            tok = self._sample_all(state, shd.full(logits), act, positions,
                                   last_tok)
            shd.assign(state.positions, positions + act.to(torch.int32))
            shd.assign(state.last_tok, torch.where(act, tok, last_tok))
        return state, tok.cpu().numpy()

    def _sampled_targets(self, state: InferenceState, logits, toks,
                         greedy, positions) -> torch.Tensor:
        """Verify's targets where some slot samples: walk the K+1
        positions in order, folding each INPUT token into presence before
        drawing its successor with that position's key — what K+1
        successive decode steps would draw, which keeps sampled
        speculation exact."""
        rows = torch.arange(self.slots, device=self.device)
        pres = shd.full(state.tok_presence).clone()
        temp = shd.full(state.sample_temp)
        cols = []
        for i in range(toks.shape[1]):
            pres[rows, toks[:, i].long()] = True
            t = self._draw(state, logits[:, i], rows, positions + i + 1, pres)
            cols.append(torch.where(temp > 0, t, greedy[:, i]))
        return torch.stack(cols, dim=1)

    def _commit_presence(self, state: InferenceState, toks, consumed,
                         act) -> None:
        """Fold exactly the inputs a verify step consumed into presence:
        the rejected tail must not reach the repetition mask."""
        rows = torch.arange(self.slots, device=self.device)
        pres = shd.full(state.tok_presence).clone()
        for j in range(toks.shape[1]):
            upd = pres.clone()
            upd[rows, toks[:, j].long()] = True
            pres = torch.where(((j < consumed) & act)[:, None], upd, pres)
        shd.assign(state.tok_presence, pres)

    def verify(self, state: InferenceState, drafts, draft_len, active):
        """One fused speculative step over ALL slots: feed each active
        slot its last token plus ``drafts`` (slots, K), verify in ONE paged
        forward, and accept the longest prefix of drafts matching the
        model's own next tokens — the argmax for a greedy slot, a draw at
        that position's key for a sampled one (drafts past ``draft_len``
        never match); recurrent/SSM rows roll back to the state at each
        slot's last accepted token (``select_verified``). Returns (state,
        emitted (slots, K+1), consumed (slots,)): slot ``s`` emitted
        ``emitted[s, :consumed[s]]``, the same tokens ``consumed[s]``
        successive :meth:`decode` calls would give, and advanced its
        position by ``consumed[s]``."""
        if not self.paged:
            raise ValueError("speculative verification writes draft KV "
                             "through page tables; build the engine with "
                             "paged=True (the --spec-k 0 contiguous path "
                             "is the parity baseline)")
        drafts = torch.as_tensor(np.asarray(drafts), dtype=torch.int32,
                                 device=self.device)
        dlen = torch.as_tensor(np.asarray(draft_len), dtype=torch.int32,
                               device=self.device)
        act = self._flags(active).bool()
        S, K = drafts.shape
        sampled = bool((state.temp_host > 0).any())
        with profiler.annotate("serve.verify"), torch.no_grad(), \
                self._context():
            positions = shd.full(state.positions)
            last_tok = shd.full(state.last_tok)
            toks = torch.cat([last_tok[:, None], drafts], dim=1)
            logits, stacked = tfm.verify_step_paged(
                state.params, self.cfg, {"tokens": self._batch_input(toks)},
                state.cache, positions, shd.full(state.page_table), act,
                dtype=self.dtype, ops=self.ops)
            logits = shd.full(logits)
            target = torch.argmax(logits, dim=-1).to(torch.int32)  # (S, K+1)
            if sampled:
                target = self._sampled_targets(state, logits, toks, target,
                                               positions)
            ar = torch.arange(K, device=self.device)[None, :]
            match = (target[:, :-1] == drafts) & (ar < dlen[:, None])
            n = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
            consumed = torch.where(act, n + 1, 0).to(torch.int32)
            select_verified(stacked, state.cache, n, act)
            if sampled:
                self._commit_presence(state, toks, consumed, act)
            last = torch.gather(target, 1, n[:, None].long())[:, 0]
            shd.assign(state.positions, positions + consumed)
            shd.assign(state.last_tok, torch.where(act, last, last_tok))
        return state, target.cpu().numpy(), consumed.cpu().numpy()
