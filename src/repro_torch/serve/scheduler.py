"""Continuous batching over the inference engine's request slots.

A copy of the reference's ``repro/serve/scheduler.py`` (host code: numpy,
no JAX), driving the port's :class:`~repro_torch.serve.engine.
InferenceEngine` through the same engine surface. The port's engine does
not implement the prefix-cache, preemption and host-tier hooks yet
(``copy_pages``, ``get/set_slot_state``, ``swap_out/swap_in``,
``spill_page``, ``restore_pages`` raise ``NotImplementedError``), so the
``prefix_cache``, ``preempt`` and ``host_cache_bytes`` branches below are
reachable only through options the port's launcher does not take yet.
Where the text says ``jax.device_get``, the port's engine copies from the
card with ``Tensor.cpu()``.

The scheduler owns the batching POLICY the engine deliberately excludes:
admit a pending request into any free slot, run the fused all-slot decode
step, harvest each active slot's token, and evict a slot the moment its
request finishes — EOS token or per-request ``max_new`` budget — so the
next pending request reuses it without reshaping the state.

Paged engines add two policy layers:

  * a host-side free list of physical pages — admission also claims
    ``ceil((patches + prompt + max_new) / page_size)`` pages for the slot
    (installed via ``engine.assign_pages``) and eviction returns them, so
    KV memory follows live tokens, not ``slots * max_len``;
  * an ADMISSION QUEUE for chunked prefill: a long prompt is inserted
    ``engine.prefill_chunk`` tokens at a time, one chunk per scheduler
    iteration, alternating with the fused all-slot decode step — admitting
    a long request no longer stalls in-flight decodes for the whole
    prompt's prefill.  ``stats["max_decode_gap_s"]`` records the worst
    stall in-flight decodes actually experienced.

PREFIX CACHE (``prefix_cache=True``): the free list grows into a
refcounted radix cache (:class:`RadixPagePool`).  A finished prefill
REGISTERS its full prompt pages under their token-prefix keys; a later
admission walks its prompt page by page against the trie and maps every
fully-matched page into its own table by bumping the page's refcount —
zero prefill compute and zero KV writes for the shared run, with prefill
resuming at the divergence offset through the ``insert_chunk`` /
``pos_start`` machinery.  A page is COPY-ON-WRITE duplicated only when
the admission must write inside a shared page (a prompt fully covered by
cached pages still re-inserts its final token for the first-token
logits).  Recurrent/SSM state is slot-major — not in pages — so on
hybrid archs the cache also stores a host-side recurrent snapshot per
registered page boundary and the resume offset is capped to boundaries
with a snapshot; replay genuinely starts at the divergence point.
Registration is INCREMENTAL: a chunked prefill registers each page the
moment its last token lands, so concurrent admissions match pages a
live slot still owns (refcount bump, CoW on divergence) — the cache
covers in-flight work, not only finished requests.

HOST TIER (``host_cache_bytes > 0``): the radix cache becomes two-tier.
When ``_reclaim`` would discard a cached (ref == 0) page, its KV rows —
and, on hybrid archs, the boundary's recurrent snapshot — are
``device_get`` into a byte-budgeted host-memory map under the same
page-granular prefix key.  A later admission extends its device-tier
match through ``host_match`` and each spilled page swaps back in by one
host-to-device scatter (``engine.restore_pages``) instead of
re-prefilling; the key moves back to the device tier in the same
transaction, so a prefix key lives in EXACTLY one tier at all times.
Eviction at both tiers is COST-AWARE, not LRU: victims are the keys
with the fewest admission-time hits (``_hits``, folded into
``lifetime_stats`` via the ``prefix_hits``/spill/restore counters),
oldest first on ties — pages are uniform size, so fewest-hits IS
lowest bytes-saved-per-hit.  When a matched run makes a plan
unfittable on a tight pool, admission degrades it page by page (host
tail first) down to a cold plan rather than deadlocking on a hit it
cannot afford.

PAGE-AWARE PREEMPTION (``preempt=True``): when admission would defer on
page exhaustion, the scheduler swaps out a victim slot — most recently
admitted first — by ``jax.device_get`` of just the victim's pool rows
plus its recurrent rows (``engine.swap_out``), frees its pages and slot,
and restores it later (``engine.swap_in``) when pages return.  A traffic
burst degrades tail latency instead of refusing admission, and every
stream stays bit-identical to the unpreempted run.

SPECULATIVE DECODING (``spec_k > 0``, paged engines): instead of one
token per fused step, each active slot asks a :class:`~repro.serve.
speculative.Drafter` for up to ``spec_k`` guessed next tokens and the
engine checks every guess in ONE ``verify`` forward, accepting the
longest prefix matching the model's own next tokens (plus the model's
next token itself).  Speculation is lossless for greedy AND sampled
slots — emitted streams are bit-identical to the ``spec_k == 0``
baseline (see ``engine._verify_fn``); acceptance only changes how many
tokens a step yields (``stats["spec_*"]``).

SAMPLING (``Request.sampling``): each request carries a
:class:`~repro.serve.sampling.SamplingParams`; admission installs it
into the engine's per-slot arrays (``engine.set_sampling``) so
heterogeneous configs — greedy and sampled — coexist in one fused
batch.  Draw keys fold by absolute stream position, so sampled streams
keep the same determinism contract as greedy ones.

Each slot's computation is independent of its neighbours (attention,
recurrent state and MoE routing are all per-row), so a request's
output is a function of (prompt, sampling params, seed) alone:
deterministic under any arrival order, slot assignment, co-batched
traffic, prefill chunking, preemption, or speculation depth — the
property ``tests/test_serve.py``, ``tests/test_serve_speculative.py``
and ``tests/test_serve_sampling.py`` pin.

``stats`` counts ONE call to :meth:`Scheduler.run`: it resets when a run
starts (a second batch is never polluted by the first's throughput or
``max_decode_gap_s``); ``lifetime_stats`` accumulates across runs.
"""
from __future__ import annotations

import time
from collections import Counter, OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.registry import MetricRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.engine import InferenceEngine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.state import InferenceState


class PagePool:
    """Host-side free list of physical KV pages with conservation checking.

    Every admission (``alloc``) and eviction (``free``) moves pages
    between the free list and a per-slot ownership map, and every
    operation re-checks the invariant the hypothesis property test in
    ``tests/test_property.py`` drives: pages are never leaked, never
    double-owned, and ``available() + pages_in_tables() == num_pages``
    at all times.  Misuse fails loudly — ``alloc`` of an occupied slot
    or beyond capacity raises, ``free`` of an unowned slot raises."""

    def __init__(self, num_pages: int):
        self.num_pages = int(num_pages)
        self._free: deque = deque(range(self.num_pages))
        self._owned: Dict[int, List[int]] = {}

    def available(self) -> int:
        return len(self._free)

    def reclaimable(self, keep: Sequence[int] = ()) -> int:
        """Pages an admission needing ``keep`` could claim right now.
        Without refcounts every non-owned page is free, so this is just
        the free list; :class:`RadixPagePool` refines it."""
        return len(self._free)

    def pages_in_tables(self) -> int:
        return sum(len(p) for p in self._owned.values())

    def owner_slots(self):
        return set(self._owned)

    def alloc(self, slot: int, n: int) -> List[int]:
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns pages "
                             f"{self._owned[slot]} (double admission)")
        if n < 1:
            raise ValueError(f"slot {slot}: cannot allocate {n} pages")
        if n > len(self._free):
            raise ValueError(f"slot {slot}: wants {n} pages, only "
                             f"{len(self._free)} free (defer admission)")
        pages = [self._free.popleft() for _ in range(n)]
        self._owned[slot] = pages
        self._check()
        return pages

    def free(self, slot: int) -> List[int]:
        if slot not in self._owned:
            raise KeyError(f"slot {slot} owns no pages (double free?)")
        pages = self._owned.pop(slot)
        self._free.extend(pages)
        self._check()
        return pages

    def table(self, slot: int) -> List[int]:
        """The ordered page run ``slot`` currently owns (its page row)."""
        return list(self._owned[slot])

    def _check(self) -> None:
        seen = list(self._free) + [p for ps in self._owned.values()
                                   for p in ps]
        assert len(seen) == len(set(seen)) == self.num_pages, \
            f"page conservation broken: {len(set(seen))} distinct of " \
            f"{len(seen)} tracked vs {self.num_pages} total"


class RadixPagePool(PagePool):
    """Refcounted radix/prefix cache over the physical page pool, with an
    optional host-memory spill tier.

    Every page is in exactly one of three states:

      * FREE        — on the free list, content meaningless;
      * IN USE      — mapped by >= 1 slot page tables; ``refcount(p)`` ==
                      the number of slots mapping it (1 = private,
                      > 1 = shared);
      * CACHED      — refcount 0 but REGISTERED in the radix trie: its KV
                      content backs a token-prefix key and can be mapped
                      by a future admission (refcount bump, zero prefill).
                      Cached pages are reclaimed on demand when the free
                      list runs short, unregistering their keys.

    The trie is host-side and page-granular: key = the full token prefix
    up to a page boundary, value = the physical page holding that page's
    KV.  ``match`` walks a prompt boundary by boundary; ``admit`` maps the
    matched run plus fresh tail pages into a slot in one transaction, with
    copy-on-write replacing any shared page the slot must write into.
    ``register`` inserts a prefill's completed prompt pages (plus optional
    per-boundary recurrent snapshots for hybrid archs) — incrementally at
    each chunk, so pages owned by a still-prefilling live slot are already
    matchable by concurrent admissions.

    THE HOST TIER (``host_bytes > 0``): a reclaimed cached page is no
    longer simply lost — ``_reclaim`` first spills its KV content (and
    its recurrent snapshot, when one is registered) into a host-memory
    dict keyed by the same prefix tuple, via the ``spill_fn`` the
    scheduler installs.  ``host_match`` continues a prompt's prefix walk
    past the device trie into the spilled keys, and ``admit`` swaps a
    matched host entry back into a freshly-claimed page (the scheduler
    scatters the blob — ``engine.restore_pages`` — the same mechanics as
    a preemption ``swap_in``), re-registering the key device-side.  A
    prefix key therefore lives in EXACTLY ONE tier at a time: spilled ∪
    device-registered keys are disjoint, and a spill/restore round trip
    conserves the cached bytes it moves.

    EVICTION is cost-aware at both tiers, replacing plain LRU: every
    admit that maps a key (device bump or host restore) increments the
    key's hit counter, and the victim is the key with the FEWEST hits,
    oldest first among ties — bytes-saved-per-hit collapses to the hit
    count because every page holds the same ``page_size`` tokens of KV.
    The counters live on the pool (they survive ``Scheduler.run``
    boundaries, like ``lifetime_stats``); the per-run spill/restore
    totals drain into the scheduler's stats via ``drain_events``.

    PR 5's conservation invariant generalizes: free + cached + in-use
    partition the pool exactly, and the sum of refcounts equals the total
    page-table occupancy (``pages_in_tables``) — re-checked after every
    operation and driven by the hypothesis test in ``test_property.py``,
    which also pins the two-tier key disjointness and the host byte
    budget."""

    def __init__(self, num_pages: int, page_size: int, *,
                 host_bytes: int = 0):
        super().__init__(num_pages)
        self.page_size = int(page_size)
        self._ref: Dict[int, int] = {}              # page -> #owning slots
        self._trie: Dict[Tuple[int, ...], int] = {}  # prefix key -> page
        self._key: Dict[int, Tuple[int, ...]] = {}   # page -> its key
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # recency
        self._snaps: Dict[Tuple[int, ...], Any] = {}  # key -> rec snapshot
        #: host spill tier: prefix key -> {"kv": blob, "snap": ..,
        #: "nbytes": int}, in recency order; capped at ``host_bytes``
        self.host_bytes = int(host_bytes)
        self._host: "OrderedDict[Tuple[int, ...], Dict[str, Any]]" = \
            OrderedDict()
        self._host_used = 0
        self._spill_fn = None       # page -> kv blob (engine.spill_page)
        #: per-key hit counters — the cost-aware eviction signal at BOTH
        #: tiers; lifetime by construction (never reset between runs)
        self._hits: Dict[Tuple[int, ...], int] = {}
        #: per-run spill/evict totals the scheduler drains into its stats
        self._events: Dict[str, int] = {"host_spilled_pages": 0,
                                        "host_evicted_pages": 0}

    def set_spill_fn(self, fn) -> None:
        """Install the page-content gather the spill path calls (the
        scheduler binds ``engine.spill_page`` over its live state); the
        host tier stays inert without one even when ``host_bytes > 0``."""
        self._spill_fn = fn

    # -- accounting --------------------------------------------------------
    def available(self) -> int:
        """Pages an admission can claim: free now + cached-reclaimable."""
        return len(self._free) + len(self._cached)

    def cached_pages(self) -> int:
        return len(self._cached)

    def in_use_pages(self) -> set:
        return set(self._ref)

    def host_pages(self) -> int:
        """Spilled prefix pages currently held in the host tier."""
        return len(self._host)

    def host_used_bytes(self) -> int:
        return self._host_used

    def spilled_keys(self) -> set:
        """The prefix keys the host tier currently backs (always disjoint
        from the device trie's keys — a key lives in exactly one tier)."""
        return set(self._host)

    def hit_count(self, key: Tuple[int, ...]) -> int:
        """Lifetime admit-time hits on ``key`` — the cost-aware eviction
        signal (a key that keeps saving prefill outlives colder ones)."""
        return self._hits.get(key, 0)

    def drain_events(self) -> Dict[str, int]:
        """Return and reset the spill/evict counters accumulated since
        the last drain — folded into the scheduler's per-run stats."""
        out = dict(self._events)
        for k in self._events:
            self._events[k] = 0
        return out

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def reclaimable(self, keep: Sequence[int] = ()) -> int:
        """Free pages plus cached (ref-0) pages OUTSIDE ``keep`` — what an
        admission that wants to map the ``keep`` run can actually claim."""
        ks = set(keep)
        return len(self._free) + sum(1 for p in self._cached if p not in ks)

    def can_admit(self, shared: Sequence[int], n_fresh: int) -> bool:
        """True when ``n_fresh`` pages can be claimed without reclaiming
        any of the ``shared`` pages the same admission wants to map."""
        return n_fresh <= self.reclaimable(shared)

    # -- the prefix walk ---------------------------------------------------
    def match(self, prompt) -> Tuple[List[int], int]:
        """Longest run of registered full pages covering ``prompt``'s
        prefix: ([physical pages], matched token count).  Touches the LRU
        so a hot prefix survives pool pressure."""
        ps = self.page_size
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        pages: List[int] = []
        for i in range(len(prompt) // ps):
            p = self._trie.get(tuple(prompt[:(i + 1) * ps]))
            if p is None:
                break
            pages.append(p)
            if p in self._cached:
                self._cached.move_to_end(p)
        return pages, len(pages) * ps

    def host_match(self, prompt, start_pages: int) -> List[Tuple[int, ...]]:
        """Host-tier continuation of a device ``match``: the prefix keys
        for page boundaries ``start_pages``, ``start_pages + 1``, ... as
        long as the host tier holds them.  Touches recency so a hot
        spilled prefix outlives colder ones under the byte budget."""
        ps = self.page_size
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        keys: List[Tuple[int, ...]] = []
        for i in range(int(start_pages), len(prompt) // ps):
            key = tuple(prompt[:(i + 1) * ps])
            if key not in self._host:
                break
            keys.append(key)
            self._host.move_to_end(key)
        return keys

    def snapshot(self, key: Tuple[int, ...]):
        """The recurrent-state snapshot registered at prefix ``key``."""
        return self._snaps[key]

    def has_snapshot(self, key: Tuple[int, ...]) -> bool:
        return key in self._snaps

    # -- transactions ------------------------------------------------------
    def _pick_victim(self) -> int:
        """Cost-aware device-tier eviction: the cached page whose key has
        saved the least prefill (fewest admit-time hits), oldest first
        among ties — bytes-saved-per-hit reduces to the hit count since
        every page holds the same ``page_size`` tokens of KV."""
        victim, vh = None, None
        for p in self._cached:              # insertion order: oldest first
            h = self._hits.get(self._key[p], 0)
            if vh is None or h < vh:
                victim, vh = p, h
                if h == 0:                  # cannot score lower
                    break
        return victim

    def _host_evict_one(self) -> None:
        """Cost-aware host-tier eviction under the byte budget: fewest
        hits first, oldest first among ties (same rule as the device
        tier — the two tiers share one hit-counter table)."""
        victim, vh = None, None
        for k in self._host:                # insertion order: oldest first
            h = self._hits.get(k, 0)
            if vh is None or h < vh:
                victim, vh = k, h
                if h == 0:
                    break
        self._host_used -= self._host.pop(victim)["nbytes"]
        self._events["host_evicted_pages"] += 1

    def _host_insert(self, key: Tuple[int, ...], kv: list, snap) -> None:
        """Spill one evicted page's content into the host tier, evicting
        colder entries until the byte budget holds (an entry larger than
        the whole budget is simply dropped)."""
        nbytes = sum(int(r.nbytes) for r in kv if r is not None)
        if snap is not None:
            nbytes += sum(int(r.nbytes) for r in snap if r is not None)
        if nbytes > self.host_bytes:
            return
        while self._host_used + nbytes > self.host_bytes:
            self._host_evict_one()
        self._host[key] = {"kv": kv, "snap": snap, "nbytes": nbytes}
        self._host_used += nbytes
        self._events["host_spilled_pages"] += 1

    def _drop_host(self, key: Tuple[int, ...]) -> None:
        """Remove ``key``'s host entry (a device registration supersedes
        it — the two tiers must stay disjoint)."""
        ent = self._host.pop(key, None)
        if ent is not None:
            self._host_used -= ent["nbytes"]
            self._events["host_evicted_pages"] += 1

    def _reclaim(self, n: int) -> None:
        """Grow the free list to ``n`` pages by evicting cached (ref-0)
        pages fewest-hits-first, unregistering their keys and snapshots —
        spilling each victim's KV content (and snapshot) into the host
        tier first when one is configured."""
        while len(self._free) < n:
            if not self._cached:
                raise ValueError(f"want {n} free pages, only "
                                 f"{len(self._free)} free and nothing "
                                 f"cached to reclaim (defer admission)")
            p = self._pick_victim()
            del self._cached[p]
            key = self._key.pop(p)
            del self._trie[key]
            snap = self._snaps.pop(key, None)
            if self.host_bytes and self._spill_fn is not None:
                self._host_insert(key, self._spill_fn(p), snap)
            self._free.append(p)

    def alloc(self, slot: int, n: int) -> List[int]:
        """Claim ``n`` fresh private pages (no sharing) — the cold path
        and the preemption-restore path."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns pages "
                             f"{self._owned[slot]} (double admission)")
        if n < 1:
            raise ValueError(f"slot {slot}: cannot allocate {n} pages")
        if n > self.available():
            raise ValueError(f"slot {slot}: wants {n} pages, only "
                             f"{self.available()} free/cached "
                             f"(defer admission)")
        self._reclaim(n)
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._owned[slot] = pages
        self._check()
        return pages

    def admit(self, slot: int, shared: Sequence[int], n_tail: int,
              cow_idx: Sequence[int] = (),
              host_keys: Sequence[Tuple[int, ...]] = (),
              n_host_reg: Optional[int] = None):
        """Map ``shared`` (refcount bump each), then one freshly-claimed
        page per spilled ``host_keys`` entry, then ``n_tail`` fresh tail
        pages into ``slot``'s table, copy-on-writing the shared pages at
        indices ``cow_idx`` (the ones the slot must write into).

        Each host key's entry is consumed from the spill tier and its
        first ``n_host_reg`` pages are RE-REGISTERED device-side (key ->
        new page, snapshot back into the snap table) — the key moves back
        to the device tier in the same transaction, keeping the tiers
        disjoint.  The scheduler excludes the final restored page from
        re-registration when the prefill resume point writes into it
        (the content is re-registered at prefill completion instead, the
        same rule CoW enforces for device-shared pages).

        Returns ``(cow_pairs, restored)``: the (src, dst) CoW pairs to
        clone device-side, and ``(page, entry)`` per host key — the
        scheduler scatters ``entry["kv"]`` into ``page``
        (``engine.restore_pages``).  Every mapped key's hit counter is
        bumped here — admit time, not match time, so deferred admissions
        re-planning each cycle cannot inflate the eviction signal."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already owns pages "
                             f"{self._owned[slot]} (double admission)")
        host_keys = list(host_keys)
        if n_host_reg is None:
            n_host_reg = len(host_keys)
        n_fresh = n_tail + len(cow_idx) + len(host_keys)
        if not self.can_admit(shared, n_fresh):
            raise ValueError(f"slot {slot}: wants {n_fresh} fresh pages "
                             f"beyond the {len(shared)} shared ones "
                             f"(defer admission)")
        for p in shared:
            if p not in self._ref and p not in self._cached:
                raise ValueError(f"page {p} is neither in use nor cached "
                                 f"(stale match?)")
        for k in host_keys:
            if k not in self._host:
                raise ValueError("host-tier key vanished between match "
                                 "and admit (stale match?)")
        owned = list(shared)
        for p in owned:                     # bump before reclaiming so the
            if p in self._cached:           # shared run cannot be evicted
                del self._cached[p]         # out from under this admission
            self._ref[p] = self._ref.get(p, 0) + 1
            key = self._key.get(p)
            if key is not None:
                self._hits[key] = self._hits.get(key, 0) + 1
        self._owned[slot] = owned           # _release needs ownership set
        # consume the host entries BEFORE reclaiming: _reclaim spills its
        # victims into the host tier, and those inserts evict cold keys —
        # possibly the very ones this admission is restoring
        ents = []
        for key in host_keys:
            ent = self._host.pop(key)
            self._host_used -= ent["nbytes"]
            ents.append(ent)
        self._reclaim(n_fresh)
        restored = []
        for j, (key, ent) in enumerate(zip(host_keys, ents)):
            p = self._free.popleft()
            self._ref[p] = 1
            owned.append(p)
            if j < n_host_reg:              # the key returns device-side
                self._trie[key] = p
                self._key[p] = key
                if ent["snap"] is not None:
                    self._snaps[key] = ent["snap"]
            self._hits[key] = self._hits.get(key, 0) + 1
            restored.append((p, ent))
        cow_pairs = []
        for i in cow_idx:
            src, dst = owned[i], self._free.popleft()
            self._release_one(src)
            self._ref[dst] = 1
            owned[i] = dst
            cow_pairs.append((src, dst))
        for _ in range(n_tail):
            p = self._free.popleft()
            self._ref[p] = 1
            owned.append(p)
        self._check()
        return cow_pairs, restored

    def _release_one(self, p: int) -> None:
        """Drop one reference to ``p``; a last owner leaves it CACHED when
        registered (its content still backs a trie key), FREE otherwise."""
        self._ref[p] -= 1
        if self._ref[p] == 0:
            del self._ref[p]
            if p in self._key:
                self._cached[p] = None      # LRU tail = most recent
            else:
                self._free.append(p)

    def free(self, slot: int) -> List[int]:
        if slot not in self._owned:
            raise KeyError(f"slot {slot} owns no pages (double free?)")
        pages = self._owned.pop(slot)
        for p in pages:
            self._release_one(p)
        self._check()
        return pages

    def register(self, slot: int, prompt, snaps: Optional[Dict] = None,
                 up_to: Optional[int] = None):
        """Insert ``slot``'s completed prompt pages into the trie (key =
        token prefix up to each page boundary).  Keys already registered
        keep their original page.  ``snaps`` maps page-boundary index
        (1-based page count) to a recurrent snapshot; when given, a
        boundary WITHOUT a snapshot is skipped — a hybrid arch must never
        match a prefix it cannot resume from.  ``up_to`` caps
        registration at the first ``up_to`` prompt tokens: a chunked
        prefill registers each page the moment its last token lands, so
        concurrent admissions match pages a LIVE slot still owns
        (refcount bump on those in-use pages, CoW on divergence) instead
        of waiting for the whole prefill to finish.  A registered key
        supersedes any host-tier copy (the tiers stay disjoint)."""
        ps = self.page_size
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        limit = len(prompt) if up_to is None else min(int(up_to),
                                                      len(prompt))
        owned = self._owned[slot]
        for i in range(min(limit // ps, len(owned))):
            key = tuple(prompt[:(i + 1) * ps])
            if key in self._trie:
                continue
            if snaps is not None and (i + 1) not in snaps:
                continue
            p = owned[i]
            if p in self._key:              # already backs another prefix
                continue
            self._trie[key] = p
            self._key[p] = key
            if snaps is not None:
                self._snaps[key] = snaps[i + 1]
            self._drop_host(key)
        self._check()

    # -- the generalized conservation invariant ----------------------------
    def _check(self) -> None:
        owned = [p for ps in self._owned.values() for p in ps]
        for slot, ps in self._owned.items():
            assert len(ps) == len(set(ps)), \
                f"slot {slot} maps page(s) twice: {ps}"
        counts = dict(Counter(owned))
        assert counts == self._ref, \
            f"refcounts {self._ref} != table occupancy {counts}"
        fr, ca, iu = set(self._free), set(self._cached), set(self._ref)
        assert len(self._free) == len(fr), "free list holds duplicates"
        assert not (fr & ca) and not (fr & iu) and not (ca & iu), \
            "page in two ownership states at once"
        assert fr | ca | iu == set(range(self.num_pages)), \
            f"page conservation broken: {len(fr)} free + {len(ca)} " \
            f"cached + {len(iu)} in use != {self.num_pages} total"
        assert sum(self._ref.values()) == self.pages_in_tables()
        assert {p: k for k, p in self._trie.items()} == self._key, \
            "trie and reverse key map diverged"
        assert ca <= set(self._key), "cached page without a trie key"
        assert set(self._snaps) <= set(self._trie), \
            "snapshot for an unregistered prefix"
        # the host-tier half: a prefix key lives in exactly one tier, and
        # the byte accounting is exact under the budget
        assert not (set(self._host) & set(self._trie)), \
            "prefix key registered in both tiers at once"
        assert self._host_used == sum(e["nbytes"]
                                      for e in self._host.values()), \
            "host-tier byte accounting drifted"
        assert self._host_used <= max(self.host_bytes, 0), \
            "host tier exceeds its byte budget"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (L,) int32 token ids
    max_new: int = 16
    extras: Dict[str, np.ndarray] = field(default_factory=dict)  # e.g. patches
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None              # last slot served in (telemetry)
    #: per-request sampling config; the default is the greedy path
    sampling: SamplingParams = field(default_factory=SamplingParams)


@dataclass
class _Admission:
    """A request whose prompt is being chunk-prefilled into its slot.

    ``cursor`` starts at the prefix-cache resume offset (0 on a cold
    admission); ``capture`` asks each page-boundary chunk to snapshot the
    slot's recurrent state so the finished prompt can register resumable
    prefixes on hybrid archs."""
    r: Request
    slot: int
    cursor: int = 0                         # prompt tokens inserted so far
    capture: bool = False                   # snapshot recurrent state at
    snaps: Dict[int, Any] = field(default_factory=dict)  # page boundaries


@dataclass
class _AdmitPlan:
    """Host-side page plan for one paged admission: how much of the prompt
    the prefix cache already holds (device pages to map, host-tier keys to
    swap back in) and what must be claimed fresh."""
    total: int                              # pages the slot will own
    shared: List[int] = field(default_factory=list)  # matched cached pages
    resume: int = 0                         # prefill resumes at this token
    cow_idx: List[int] = field(default_factory=list)  # shared idx to CoW
    snap_key: Optional[Tuple[int, ...]] = None  # recurrent snapshot to load
    #: spilled prefix keys continuing the device run — each restores into
    #: a freshly-claimed page instead of re-prefilling
    host_keys: List[Tuple[int, ...]] = field(default_factory=list)
    #: how many of ``host_keys`` re-register device-side (all but a final
    #: restored page the resume point writes into)
    n_host_reg: int = 0

    @property
    def fresh_needed(self) -> int:
        # host-restored pages claim from the free list like the tail does,
        # so they are already inside ``total - len(shared)``
        return self.total - len(self.shared) + len(self.cow_idx)


@dataclass
class _Swapped:
    """A preempted request: its host-side swap blob awaiting restore."""
    r: Request
    blob: Dict[str, Any]
    n_pages: int


#: the scheduler's per-run stat family — one ``MetricRegistry`` StatGroup
#: per scheduler under ``sched.run.*`` (and its lifetime twin under
#: ``sched.lifetime.*``), keeping the historical flat-dict API
_STAT_DEFAULTS: Dict[str, float] = {
    "prefill_tokens": 0, "prefill_s": 0.0, "prefill_chunks": 0,
    "decode_tokens": 0, "decode_s": 0.0, "decode_steps": 0,
    # slot-steps: sum over fused rounds of |active slots| — the
    # denominator for accepted-tokens-per-step (== decode_tokens
    # without speculation; smaller when drafts are accepted)
    "decode_slot_steps": 0,
    # worst single stall; the full distribution lives in the
    # ``serve.decode_gap_s`` histogram (``Scheduler.decode_gaps``)
    "max_decode_gap_s": 0.0,
    # speculative counters: proposed drafts, drafts accepted,
    # verify rounds (a subset of decode_steps)
    "spec_proposed": 0, "spec_accepted": 0, "spec_steps": 0,
    # admission-pressure counters: total defer cycles across
    # requests, and the worst single request's defer count
    "deferred_admissions": 0, "max_defer_cycles": 0,
    # prefix-cache counters: admissions that consulted the
    # trie, admissions that mapped >= 1 cached page, prefill
    # tokens skipped by resuming past the shared run, and
    # pages copy-on-write duplicated
    "prefix_lookups": 0, "prefix_hits": 0,
    "prefix_hit_tokens": 0, "cow_pages": 0,
    # host spill tier: admissions that swapped >= 1 spilled
    # page back in, the pages and prefill tokens those swaps
    # covered, and the pool's spill/evict traffic (drained
    # from RadixPagePool at the end of each run)
    "host_hits": 0, "host_restored_pages": 0,
    "host_hit_tokens": 0, "host_spilled_pages": 0,
    "host_evicted_pages": 0,
    # page-aware preemption: victims swapped to host, swapped
    # requests restored into a slot
    "preemptions": 0, "restores": 0}


class Scheduler:
    """Drives an :class:`InferenceEngine` over a queue of requests."""

    def __init__(self, engine: InferenceEngine, state: InferenceState, *,
                 eos_id: Optional[int] = None, spec_k: int = 0,
                 drafter=None, prefix_cache: bool = False,
                 preempt: bool = False, host_cache_bytes: int = 0,
                 registry: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.engine = engine
        self.state = state
        self.eos_id = eos_id
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k and not engine.paged:
            raise ValueError("speculative decoding runs over the paged KV "
                             "pool; spec_k > 0 requires paged=True "
                             "(spec_k=0 is the parity baseline)")
        self.prefix_cache = bool(prefix_cache)
        self.preempt = bool(preempt)
        self.host_cache_bytes = int(host_cache_bytes)
        if (self.prefix_cache or self.preempt) and not engine.paged:
            raise ValueError("prefix_cache/preempt are page-pool policies; "
                             "both require paged=True")
        if self.host_cache_bytes and not self.prefix_cache:
            raise ValueError("host_cache_bytes spills evicted prefix-cache "
                             "pages to host memory; it requires "
                             "prefix_cache=True")
        if self.spec_k and drafter is None:
            from repro_torch.serve.speculative import NgramDrafter
            drafter = NgramDrafter()
        self.drafter = drafter
        #: per-slot rid history — lets tests assert slots are actually reused
        self.slot_history: Dict[int, List[int]] = {
            s: [] for s in range(engine.slots)}
        #: telemetry: every measurement lands in the registry (pass one in
        #: to share a store across schedulers/launchers) and every phase
        #: emits a span on the tracer — both pure host-side, so enabling
        #: them cannot perturb emitted streams (``tests/test_obs.py``)
        self.registry = registry if registry is not None else MetricRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        #: the historical flat per-run stats dict, now a registry StatGroup
        #: view: same dict API (``stats[k] += v``, ``dict(stats)``), every
        #: key visible to snapshot/dump as ``sched.run.<key>``
        self.stats = self.registry.group("sched.run", _STAT_DEFAULTS)
        #: accumulated across every finished/aborted run() on this scheduler
        self.lifetime_stats = self.registry.group("sched.lifetime",
                                                  _STAT_DEFAULTS)
        #: decode-gap DISTRIBUTION (the stall metric): per run, like
        #: ``stats`` — ``decode_gaps.quantile(99)`` replaces eyeballing
        #: the ``max_decode_gap_s`` scalar (which stays, as the p100)
        self.decode_gaps = self.registry.histogram("serve.decode_gap_s")
        if engine.paged:
            if self.prefix_cache:
                self._pages = RadixPagePool(
                    engine.num_pages, engine.page_size,
                    host_bytes=self.host_cache_bytes)

                # the spill hook closes over the live state: by the time
                # _reclaim fires the scheduler's state IS the engine state
                def _spill(page):
                    with self.tracer.span("spill", page=page):
                        return self.engine.spill_page(self.state, page)

                self._pages.set_spill_fn(_spill)
            else:
                self._pages = PagePool(engine.num_pages)
        else:
            self._pages = None
        self._last_decode_t: Optional[float] = None
        #: per-request time-to-first-token for the current run (seconds
        #: from run() start to the request's first generated token) — a
        #: registry Series, so the plain dict API callers index is the
        #: same store the metrics dump reports as ``serve.ttft_s``
        self.ttft = self.registry.series("serve.ttft_s")
        self._run_t0: float = 0.0
        self._rid_open: Dict[int, Optional[int]] = {}  # rid -> open span
        self._defer_counts: Dict[int, int] = {}
        self._admit_seq: Dict[int, int] = {}   # slot -> admission sequence
        self._seq = 0
        #: global admission/restore completion order for the current run
        #: (rid per event; a preempted rid appears once per restore) —
        #: what the fairness regression tests assert on
        self.admission_order: List[int] = []
        # slots whose per-slot sampling rows were left non-greedy: a later
        # greedy admission must reset them, while greedy-into-greedy slot
        # reuse skips the host round-trip entirely (the default rows are
        # already greedy)
        self._sampled_slots: set = set()

    def _drain_pool_events(self) -> None:
        """Fold the pool's spill/evict event counters into this run's
        stats.  Spills happen inside ``_reclaim`` — under some OTHER
        request's admission — so the pool accumulates them off to the
        side and the scheduler drains them once per run, right before the
        lifetime fold (the cost-aware eviction's input signal)."""
        if isinstance(self._pages, RadixPagePool):
            for k, v in self._pages.drain_events().items():
                self.stats[k] += v

    def _fold_lifetime(self) -> None:
        for k, v in self.stats.items():
            if k in ("max_decode_gap_s", "max_defer_cycles"):  # maxima
                self.lifetime_stats[k] = max(self.lifetime_stats[k], v)
            else:
                self.lifetime_stats[k] += v

    def _done(self, r: Request) -> bool:
        if not r.generated:
            return False
        if self.eos_id is not None and r.generated[-1] == self.eos_id:
            return True
        return len(r.generated) >= r.max_new

    # -- admission ---------------------------------------------------------
    def _total_len(self, r: Request) -> int:
        patches = int(np.shape(r.extras["patches"])[0]) \
            if "patches" in r.extras else 0
        return patches + len(np.asarray(r.prompt)) + r.max_new

    def _pages_needed(self, r: Request) -> int:
        return -(-self._total_len(r) // self.engine.page_size)

    def _validate(self, r: Request) -> None:
        try:
            r.sampling.validate()
        except ValueError as e:
            raise ValueError(f"request {r.rid}: {e}") from None
        if r.max_new < 1:
            # the prefill itself emits the first greedy token, so a budget
            # below one token is unservable rather than silently exceeded
            raise ValueError(f"request {r.rid}: max_new must be >= 1")
        total = self._total_len(r)
        if total > self.engine.max_len:
            raise ValueError(
                f"request {r.rid}: patches + prompt + max_new = {total} "
                f"exceeds engine max_len {self.engine.max_len} (the cache "
                f"would wrap and overwrite live context)")
        if self.engine.paged and self._pages_needed(r) > self.engine.num_pages:
            raise ValueError(
                f"request {r.rid}: needs {self._pages_needed(r)} pages but "
                f"the pool only has {self.engine.num_pages}")

    def _alloc_pages(self, r: Request, slot: int) -> None:
        pages = self._pages.alloc(slot, self._pages_needed(r))
        self.state = self.engine.assign_pages(self.state, slot, pages)

    def _plan(self, r: Request,
              max_run: Optional[int] = None) -> _AdmitPlan:
        """Page plan for admitting ``r``: walk the prefix cache (when on)
        across BOTH tiers — the device trie first, then the host spill
        tier continuing from where the trie walk broke — and decide the
        shared run, the prefill resume offset, and which shared pages
        must be copy-on-write duplicated.  ``max_run`` caps the combined
        matched run (host tail dropped first): the admission loop
        degrades an unfittable plan page by page down to a cold admission
        instead of deferring forever on a pool too tight to both KEEP the
        shared run and claim the fresh pages around it."""
        total = self._pages_needed(r)
        if not self.prefix_cache or "patches" in r.extras:
            return _AdmitPlan(total)
        prompt = np.asarray(r.prompt, np.int32).ravel()
        with self.tracer.span("prefix_match", rid=r.rid):
            shared, matched = self._pages.match(prompt)
            host_keys = self._pages.host_match(prompt, len(shared))
        ps = self.engine.page_size
        cap = len(shared) + len(host_keys)
        if max_run is not None:
            cap = min(cap, max_run)
        if self.engine.has_recurrent_state:
            # recurrent/SSM state lives in slot rows, not pages: resume
            # only from a boundary with a registered snapshot, and always
            # keep >= 1 prompt token to re-insert (the first-token logits
            # come out of the prefill) — so the resume point is a boundary
            # and no shared page is ever written into (no CoW needed).
            # Spilled entries carry their boundary snapshot, so a host
            # key is as resumable as a device one.
            cap = min(cap, (len(prompt) - 1) // ps)
        if cap <= len(shared):
            shared, host_keys = shared[:cap], []
        else:
            host_keys = host_keys[:cap - len(shared)]
        if not shared and not host_keys:
            return _AdmitPlan(total)
        matched = cap * ps
        resume = min(matched, len(prompt) - 1)
        # a prompt fully covered by cached pages still re-inserts its last
        # token for the first-token logits: that write lands INSIDE the
        # final matched page — a device-shared page needs a private CoW
        # copy; a host-restored page is already private, so it is simply
        # left unregistered until prefill completion re-registers it
        cow_idx = list(range(resume // ps, len(shared)))
        snap_key = tuple(int(t) for t in prompt[:resume]) \
            if self.engine.has_recurrent_state else None
        n_host_reg = min(len(host_keys),
                         max(0, resume // ps - len(shared)))
        return _AdmitPlan(total, list(shared), resume, cow_idx, snap_key,
                          host_keys, n_host_reg)

    def _fits(self, plan: _AdmitPlan, reserve: int = 0) -> bool:
        """Can ``plan`` be claimed while leaving ``reserve`` pages
        untouched?  ``reserve`` is the parked restore head's page need —
        pending admissions must not starve it out of the headroom it is
        owed (see the restore phase in :meth:`_run`)."""
        if isinstance(self._pages, RadixPagePool):
            return self._pages.can_admit(plan.shared,
                                         plan.fresh_needed + reserve)
        return self._pages.available() >= plan.total + reserve

    def _preempt_gain(self, active: Dict[int, "Request"],
                      plan: _AdmitPlan) -> int:
        """Pages that preempting EVERY active slot would actually return
        to the claimable set.  Under the prefix cache a page only leaves
        the in-use state when its refcount drops to 0, so pages shared
        with a non-preemptable owner (a mid-chunk admission, or the
        plan's own shared run) must not be counted — the old bound
        ``sum(len(table(s)))`` overcounted exactly those, letting the
        scheduler swap out every victim and still defer (a preemption
        storm with zero admission progress)."""
        tables = [self._pages.table(s) for s in active]
        if not isinstance(self._pages, RadixPagePool):
            return sum(len(t) for t in tables)
        refs = Counter(p for t in tables for p in t)
        keep = set(plan.shared)
        return sum(1 for p, c in refs.items()
                   if p not in keep and self._pages.refcount(p) == c)

    def _claim_pages(self, r: Request, slot: int, plan: _AdmitPlan) -> None:
        """Execute ``plan``: map shared + restored + fresh pages into
        ``slot``'s page table, scatter host-tier spill blobs back into
        the restored pages, clone CoW pages device-side, and load the
        recurrent snapshot the resume point needs (hybrid archs)."""
        if not isinstance(self._pages, RadixPagePool):
            self._alloc_pages(r, slot)
            return
        n_tail = plan.total - len(plan.shared) - len(plan.host_keys)
        cow_pairs, restored = self._pages.admit(
            slot, plan.shared, n_tail, plan.cow_idx,
            host_keys=plan.host_keys, n_host_reg=plan.n_host_reg)
        row = self._pages.table(slot)
        keep = set(plan.shared) - {s for s, _ in cow_pairs}
        # only non-shared pages get their pos metadata cleared: the shared
        # run's pos entries ARE the cached KV's validity record (restored
        # pages are cleared, then fully overwritten by the scatter below)
        fresh = [p for p in row if p not in keep]
        self.state = self.engine.assign_pages(self.state, slot, row,
                                              fresh=fresh)
        if restored:
            # the host-tier hit: spilled KV returns by one host-to-device
            # scatter — the prefill those pages held is skipped again
            with self.tracer.span("restore_pages", pages=len(restored)):
                self.state = self.engine.restore_pages(
                    self.state, [p for p, _ in restored],
                    [ent["kv"] for _, ent in restored])
            self.stats["host_hits"] += 1
            self.stats["host_restored_pages"] += len(restored)
            self.stats["host_hit_tokens"] += \
                len(restored) * self.engine.page_size
        if cow_pairs:
            self.state = self.engine.copy_pages(
                self.state, [s for s, _ in cow_pairs],
                [d for _, d in cow_pairs])
            self.stats["cow_pages"] += len(cow_pairs)
            self.tracer.instant("cow", pages=len(cow_pairs))
        self.stats["prefix_lookups"] += 1
        if plan.shared or plan.host_keys:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += plan.resume
        if plan.snap_key is not None:
            self.state = self.engine.set_slot_state(
                self.state, slot, self._pages.snapshot(plan.snap_key))

    def _set_sampling(self, r: Request, slot: int) -> None:
        """Install ``r``'s sampling config into ``slot`` before its first
        prefill.  Greedy requests entering a slot that is still greedy
        skip the host-side write — the engine's default rows already
        encode the argmax path, which keeps pure-greedy serving on
        exactly the pre-sampling admission sequence."""
        sp = r.sampling
        if sp.greedy and slot not in self._sampled_slots:
            return
        self.state = self.engine.set_sampling(self.state, slot, sp,
                                              np.asarray(r.prompt, np.int32))
        if sp.greedy:
            self._sampled_slots.discard(slot)
        else:
            self._sampled_slots.add(slot)

    def _defer(self, r: Request) -> None:
        self.tracer.instant("defer", rid=r.rid)
        self.stats["deferred_admissions"] += 1
        n = self._defer_counts.get(r.rid, 0) + 1
        self._defer_counts[r.rid] = n
        self.stats["max_defer_cycles"] = max(
            self.stats["max_defer_cycles"], n)

    def _note_first(self, r: Request) -> None:
        if r.rid not in self.ttft:
            # ONE clock read feeds both the legacy ttft value and the
            # prefill->decode span boundary, so span-derived TTFT equals
            # this dict to float precision (acceptance bound: 1 ms)
            now = time.perf_counter()
            self.ttft[r.rid] = now - self._run_t0
            self._req_phase(r.rid, "decode", at=now)

    # -- per-request lifecycle spans ----------------------------------------
    def _req_phase(self, rid: int, name: str,
                   at: Optional[float] = None) -> None:
        """Close ``rid``'s current lifecycle span (if any) and open
        ``name`` back-to-back at the same timestamp, on the request's own
        ``rid<N>`` trace track — so each track is a gapless sequence of
        queued/prefill/decode/preempted spans."""
        if at is None:
            at = time.perf_counter()
        h = self._rid_open.pop(rid, None)
        if h is not None:
            self.tracer.end(h, at=at)
        self._rid_open[rid] = self.tracer.begin(name, tid=f"rid{rid}",
                                                at=at, rid=rid)

    def _req_end(self, r: Request) -> None:
        """Close ``r``'s lifecycle track with a ``finish`` instant."""
        now = time.perf_counter()
        h = self._rid_open.pop(r.rid, None)
        if h is not None:
            self.tracer.end(h, at=now)
        self.tracer.instant("finish", tid=f"rid{r.rid}", at=now, rid=r.rid,
                            tokens=len(r.generated))

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _preempt_one(self, active: Dict[int, Request], free: deque,
                     swapped: "deque[_Swapped]") -> None:
        """Swap out the most recently admitted active slot: device_get of
        just its pool rows + recurrent rows, free its pages and slot, park
        the request on the restore queue.  ALL its pages travel in the
        blob — shared ones included, since their cached copies may be
        reclaimed before the restore — and the restore claims all-fresh
        pages, so a swapped request never depends on cache residency."""
        slot = max(active, key=lambda s: self._admit_seq.get(s, 0))
        r = active.pop(slot)
        pages = self._pages.table(slot)
        with self.tracer.span("swap_out", rid=r.rid, pages=len(pages)):
            blob = self.engine.swap_out(self.state, slot, pages)
            self._pages.free(slot)
            self.state = self.engine.release_pages(self.state, slot)
        free.append(slot)
        if self.drafter is not None:
            self.drafter.release(slot)
        swapped.append(_Swapped(r, blob, len(pages)))
        self.stats["preemptions"] += 1
        self._req_phase(r.rid, "preempted")

    def _evict(self, slot: int, free: deque) -> None:
        free.append(slot)
        if self.engine.paged:
            self._pages.free(slot)
            # clear the slot's page row: the freed pages may be reassigned
            # immediately, and a stale row would let any later unmasked
            # write through this slot land in the new owner's pages
            self.state = self.engine.release_pages(self.state, slot)
        if self.drafter is not None:
            self.drafter.release(slot)

    def _chunkable(self, r: Request, chunk: int) -> bool:
        # VLM prompts prefill whole: the image patches and prompt tokens
        # embed as one stream, and patches dominate the prefix anyway
        return chunk > 0 and "patches" not in r.extras \
            and len(np.asarray(r.prompt)) > chunk

    def _admit(self, r: Request, slot: int) -> None:
        """Whole-prompt prefill-insert of ``r`` into ``slot``."""
        prompt = np.asarray(r.prompt, np.int32)
        inputs = {"tokens": prompt[None, :]}
        for k, v in r.extras.items():
            inputs[k] = np.asarray(v)[None]
        t0 = time.perf_counter()
        h = self.tracer.begin("prefill_insert", at=t0, rid=r.rid)
        self.state, tok = self.engine.insert(self.state, inputs, slot)
        first = int(np.asarray(tok)[0])     # sync point ends the timing
        now = time.perf_counter()
        self.tracer.end(h, at=now)
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += sum(
            int(np.shape(v)[1]) for v in inputs.values())
        r.generated.append(first)
        r.slot = slot
        self.slot_history[slot].append(r.rid)
        self.admission_order.append(r.rid)
        self._note_first(r)

    def _prefill_one_chunk(self, adm: _Admission) -> bool:
        """Insert the next chunk of ``adm``; True once the prompt is done.

        ``capture`` admissions clip every chunk to the next page boundary
        and snapshot the slot's recurrent state there, so each registered
        prefix page carries the state a future admission resumes from."""
        r = adm.r
        prompt = np.asarray(r.prompt, np.int32)
        remaining = len(prompt) - adm.cursor
        c = self.engine.prefill_chunk or remaining
        if adm.capture:
            ps = self.engine.page_size
            c = min(c, ps - adm.cursor % ps)
        c = min(c, remaining)
        toks = prompt[None, adm.cursor:adm.cursor + c]
        t0 = time.perf_counter()
        h = self.tracer.begin("prefill_chunk", at=t0, rid=r.rid,
                              cursor=adm.cursor, tokens=int(c))
        self.state, tok = self.engine.insert_chunk(
            self.state, {"tokens": toks}, adm.slot, adm.cursor)
        first = int(np.asarray(tok)[0])     # sync point ends the timing
        now = time.perf_counter()
        self.tracer.end(h, at=now)
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += c
        self.stats["prefill_chunks"] += 1
        adm.cursor += c
        if adm.capture and adm.cursor % self.engine.page_size == 0:
            adm.snaps[adm.cursor // self.engine.page_size] = \
                self.engine.get_slot_state(self.state, adm.slot)
        if self.prefix_cache and "patches" not in r.extras:
            # in-flight registration: every completed page becomes
            # matchable the moment its last token lands, so a concurrent
            # admission sharing this prompt's prefix rides the LIVE
            # slot's pages (refcount bump, CoW on divergence) instead of
            # waiting for the whole prefill to finish
            self._pages.register(adm.slot, prompt,
                                 snaps=adm.snaps if adm.capture else None,
                                 up_to=adm.cursor)
        if adm.cursor < len(prompt):
            return False
        r.generated.append(first)           # final chunk's emitted token
        r.slot = adm.slot
        self.slot_history[adm.slot].append(r.rid)
        self.admission_order.append(r.rid)
        self._note_first(r)
        return True

    # -- speculation -------------------------------------------------------
    def _spec_round(self, active: Dict[int, Request], mask: np.ndarray):
        """One speculative decode round: draft for every active slot with
        budget headroom, verify all drafts in one fused forward.  Returns
        (emitted (slots, >=1) greedy tokens, consumed (slots,)); falls
        back to the plain fused decode when nothing was drafted (so an
        empty-handed drafter costs a (slots, K+1)-shaped forward nothing).
        """
        S, K = self.engine.slots, self.spec_k
        drafts = np.zeros((S, K), np.int32)
        dlen = np.zeros((S,), np.int32)
        wants = {}
        for slot, r in active.items():
            # cap so consumed <= remaining budget: the verify step advances
            # the slot by every accepted token, and acceptance beyond the
            # budget could not be rolled back host-side
            k_s = min(K, r.max_new - len(r.generated) - 1)
            if k_s > 0:
                wants[slot] = (np.concatenate(
                    [np.asarray(r.prompt, np.int32),
                     np.asarray(r.generated, np.int32)]), k_s)
        proposals = {}
        if wants:
            with self.tracer.span("spec_propose", slots=len(wants)):
                proposals = self.drafter.propose(wants)
        for slot, d in proposals.items():
            d = np.asarray(d, np.int32).ravel()[:wants[slot][1]]
            drafts[slot, :len(d)] = d
            dlen[slot] = len(d)
        self.stats["spec_proposed"] += int(dlen.sum())
        if not dlen.any():
            self.state, toks = self.engine.decode(self.state, active=mask)
            return np.asarray(toks)[:, None], mask.astype(np.int32)
        with self.tracer.span("spec_verify", drafted=int(dlen.sum())):
            self.state, emitted, consumed = self.engine.verify(
                self.state, drafts, dlen, mask)
            emitted, consumed = np.asarray(emitted), np.asarray(consumed)
        self.stats["spec_steps"] += 1
        self.stats["spec_accepted"] += int(consumed[mask].sum() - mask.sum())
        return emitted, consumed

    # -- the serving loop --------------------------------------------------
    def run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        """Serve ``requests`` to completion; returns {rid: generated}.

        ``stats`` describes this run alone (reset here); totals across
        runs accumulate in ``lifetime_stats``."""
        self.stats.reset()
        self.decode_gaps.reset()
        self._last_decode_t = None
        self.ttft.clear()
        self._run_t0 = time.perf_counter()
        self._defer_counts = {}
        self._admit_seq = {}
        self._seq = 0
        self.admission_order = []
        self._rid_open = {}
        h_run = self.tracer.begin("run", at=self._run_t0,
                                  requests=len(requests))
        try:
            return self._run(requests)
        finally:
            for h in self._rid_open.values():   # aborted-run lifecycles
                self.tracer.end(h)
            self._rid_open.clear()
            self.tracer.end(h_run)
            self._drain_pool_events()
            self._fold_lifetime()

    def _run(self, requests: Sequence[Request]) -> Dict[int, List[int]]:
        for r in requests:
            # fail fast on the whole queue (host-side and cheap): an
            # unservable request deep in the queue must not discard the
            # tokens already generated for the requests ahead of it
            self._validate(r)
        for r in requests:
            # every request's lifecycle track starts queued at run start
            # (the arrival model run() exposes — a whole queue at once)
            self._req_phase(r.rid, "queued", at=self._run_t0)
        pending = deque(requests)
        active: Dict[int, Request] = {}
        admissions: deque[_Admission] = deque()
        swapped: deque[_Swapped] = deque()
        free = deque(range(self.engine.slots))
        chunk = self.engine.prefill_chunk if self.engine.paged else 0
        while pending or active or admissions or swapped:
            # one "iter" span per loop pass: with the nested phase spans it
            # accounts for effectively all wall-clock between the first
            # admission and the last finish (the >= 95% coverage gate)
            h_it = self.tracer.begin("iter")
            progressed = False
            # restore preempted requests first (their pages and slot were
            # taken to absorb a burst — they are owed the next headroom);
            # a restore claims all-fresh pages and never preempts, so a
            # preempt/restore pair can never livelock
            while swapped:
                sw = swapped[0]
                if not free or self._pages.available() < sw.n_pages:
                    # the head keeps waiting — record the cycle so the
                    # wait shows up in deferred_admissions either way
                    self._defer(sw.r)
                    break
                swapped.popleft()
                slot = free.popleft()
                with self.tracer.span("swap_in", rid=sw.r.rid,
                                      pages=sw.n_pages):
                    pages = self._pages.alloc(slot, sw.n_pages)
                    self.state = self.engine.swap_in(self.state, slot,
                                                     pages, sw.blob)
                self._req_phase(sw.r.rid, "decode")
                if sw.r.sampling.greedy:
                    self._sampled_slots.discard(slot)
                else:
                    self._sampled_slots.add(slot)
                self._admit_seq[slot] = self._next_seq()
                sw.r.slot = slot
                self.slot_history[slot].append(sw.r.rid)
                self.admission_order.append(sw.r.rid)
                active[slot] = sw.r
                self.stats["restores"] += 1
                progressed = True
            # pages the parked restore head is owed: pending admissions
            # below must fit WITHOUT them, or the very pages the head
            # waits for get claimed out from under it cycle after cycle
            # (a small-request flood would starve a large restore forever)
            reserve = swapped[0].n_pages if swapped else 0
            # admit pending requests into free slots (claiming pages first
            # in paged mode — a short free list defers admission until an
            # eviction returns pages, unless preemption can take them from
            # the most recently admitted active slot)
            while pending and free:
                r = pending[0]
                h_adm = self.tracer.begin("admit", rid=r.rid)
                plan = self._plan(r) if self.engine.paged else None
                if self.engine.paged and not self._fits(plan, reserve):
                    while self.preempt and active and \
                            not self._fits(plan, reserve) and \
                            plan.fresh_needed + reserve <= \
                            self._pages.reclaimable(plan.shared) + \
                            self._preempt_gain(active, plan):
                        self._preempt_one(active, free, swapped)
                        progressed = True
                    # a matched run can make a plan UNFITTABLE on a tight
                    # pool (the shared pages are pinned, and CoW + host
                    # restores each cost a fresh page) even when a plain
                    # cold admission would fit — degrade the plan page by
                    # page (host tail drops first) down to cold before
                    # giving up, or a queue with nothing in flight would
                    # deadlock on a hit it cannot afford
                    while not self._fits(plan, reserve) and \
                            (plan.shared or plan.host_keys):
                        plan = self._plan(r, max_run=len(plan.shared) +
                                          len(plan.host_keys) - 1)
                    if not self._fits(plan, reserve):
                        self.tracer.end(h_adm, deferred=True)
                        self._defer(r)
                        break
                pending.popleft()
                slot = free.popleft()
                self._admit_seq[slot] = self._next_seq()
                self._req_phase(r.rid, "prefill")
                if self.engine.paged:
                    self._claim_pages(r, slot, plan)
                self._set_sampling(r, slot)
                resume = plan.resume if plan is not None else 0
                capture = self.prefix_cache \
                    and self.engine.has_recurrent_state \
                    and "patches" not in r.extras
                if resume > 0 or self._chunkable(r, chunk) or \
                        (capture and len(np.asarray(r.prompt))
                         >= self.engine.page_size):
                    admissions.append(_Admission(r, slot, cursor=resume,
                                                 capture=capture))
                    progressed = True
                else:
                    self._admit(r, slot)
                    progressed = True
                    if self.prefix_cache and not capture \
                            and "patches" not in r.extras:
                        self._pages.register(
                            slot, np.asarray(r.prompt, np.int32))
                    if self._done(r):       # EOS straight out of prefill
                        self._req_end(r)
                        self._evict(slot, free)
                    else:
                        active[slot] = r
                self.tracer.end(h_adm, slot=slot)
            # one prefill chunk of the admission at the head of the queue,
            # then fall through to the all-slot decode: long-prompt
            # admission interleaves with in-flight decodes
            if admissions:
                adm = admissions[0]
                progressed = True
                if self._prefill_one_chunk(adm):
                    admissions.popleft()
                    if self._done(adm.r):
                        self._req_end(adm.r)
                        self._evict(adm.slot, free)
                    else:
                        active[adm.slot] = adm.r
            if active:
                progressed = True
                mask = None
                if self.engine.paged:
                    mask = np.zeros((self.engine.slots,), bool)
                    mask[list(active)] = True
                t0 = time.perf_counter()
                h_dec = self.tracer.begin("decode_step", at=t0,
                                          slots=len(active))
                if self.spec_k:
                    emitted, consumed = self._spec_round(active, mask)
                else:
                    self.state, toks = self.engine.decode(self.state,
                                                          active=mask)
                    emitted = np.asarray(toks)[:, None]
                    consumed = np.ones((self.engine.slots,), np.int32)
                now = time.perf_counter()   # emitted is host -> synced
                self.tracer.end(h_dec, at=now)
                self.stats["decode_s"] += now - t0
                self.stats["decode_steps"] += 1
                self.stats["decode_slot_steps"] += len(active)
                if self._last_decode_t is not None:
                    gap = now - self._last_decode_t
                    self.stats["max_decode_gap_s"] = max(
                        self.stats["max_decode_gap_s"], gap)
                    self.decode_gaps.record(gap)
                self._last_decode_t = now
                for slot, r in list(active.items()):
                    # a spec round can emit several tokens; honor EOS as
                    # soon as it lands (the slot's cache advanced past it,
                    # but a finished request's slot is evicted anyway)
                    for tok in emitted[slot, :consumed[slot]]:
                        r.generated.append(int(tok))
                        self.stats["decode_tokens"] += 1
                        if self._done(r):
                            break
                    if self._done(r):
                        del active[slot]
                        self._req_end(r)
                        self._evict(slot, free)
                if not active:
                    self._last_decode_t = None
            self.tracer.end(h_it)
            if not progressed:
                # nothing in flight can ever free the pages the head
                # request needs — admission would spin forever
                raise RuntimeError(
                    "admission deadlock: pending/swapped requests but no "
                    "free slot/pages and nothing in flight to evict")
        return {r.rid: list(r.generated) for r in requests}
