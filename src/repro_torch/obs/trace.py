"""Request-lifecycle tracer: spans with monotonic timestamps, exported as

A copy of the reference's ``repro/obs/trace.py`` (host code: numpy, no JAX), kept
bit-equal in behaviour by ``tests/test_torch_serve_lm.py``.
Chrome trace-event JSON (open in Perfetto / ``chrome://tracing``).

Span taxonomy (the names the scheduler emits; see
``src/repro/serve/README.md`` for the full walk-through):

  * track ``sched`` — the scheduler's compute phases, strictly nested
    because the loop is single-threaded: ``run`` > ``iter`` > one of
    ``admit`` (containing ``prefix_match``, plus ``cow`` /
    ``restore_pages`` when the prefix cache maps pages),
    ``prefill_insert``, ``prefill_chunk``, ``decode_step`` (containing
    ``spec_propose`` / ``spec_verify`` on speculative rounds),
    ``swap_out``, ``swap_in``; ``spill`` spans fire inside whichever
    admission triggered the pool reclaim; ``defer`` is an instant;
  * track ``rid<N>`` — one request's lifecycle as back-to-back spans:
    ``queued`` (run start / arrival -> admission), ``prefill``
    (admission -> first emitted token), ``decode`` (first token ->
    finish), ``preempted`` (swap-out -> restore, splitting ``decode``),
    closed by a ``finish`` instant carrying the token count.

Timestamps come from one ``time.perf_counter`` epoch per tracer, in
microseconds — monotonic within a trace, and shared with the metric
values derived from it: the scheduler records TTFT and its lifecycle
span boundary from the SAME clock read, so span-derived request metrics
(:func:`derive_request_metrics`) agree with the legacy ``sched.ttft``
dict to float precision, not merely "within a millisecond".

A disabled tracer (``Tracer(enabled=False)``) drops everything at the
``begin``/``instant`` call site; tracing is pure host-side bookkeeping
either way, so emitted token streams are bit-identical with tracing on
or off (pinned by ``tests/test_obs.py``).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple


class Tracer:
    """Span collector with begin/end handles and a Chrome-trace export."""

    def __init__(self, enabled: bool = True,
                 max_events: int = 1_000_000) -> None:
        self.enabled = bool(enabled)
        self.max_events = int(max_events)
        self._t0 = time.perf_counter()
        self._events: List[Dict[str, Any]] = []
        self._open: Dict[int, Tuple[str, str, float, Dict[str, Any]]] = {}
        self._next = 0

    # -- clocks ------------------------------------------------------------
    @property
    def t0(self) -> float:
        """The ``time.perf_counter`` value at ts == 0."""
        return self._t0

    def now(self) -> float:
        """Current ``time.perf_counter`` — the clock every span uses, so
        callers deriving their own metrics stay on the span timebase."""
        return time.perf_counter()

    def _us(self, at: Optional[float]) -> float:
        return ((time.perf_counter() if at is None else at)
                - self._t0) * 1e6

    # -- recording ---------------------------------------------------------
    def begin(self, name: str, tid: str = "sched",
              at: Optional[float] = None, **args) -> Optional[int]:
        """Open a span; returns the handle ``end`` closes (None when
        disabled).  ``at`` pins the start to an explicit perf_counter
        read (e.g. the run start for ``queued`` spans)."""
        if not self.enabled:
            return None
        h = self._next
        self._next += 1
        self._open[h] = (name, tid, self._us(at), args)
        return h

    def end(self, handle: Optional[int], at: Optional[float] = None,
            **extra) -> None:
        if handle is None or not self.enabled:
            return
        ent = self._open.pop(handle, None)
        if ent is None:
            return
        name, tid, ts, args = ent
        if extra:
            args = {**args, **extra}
        self._push({"name": name, "ph": "X", "ts": ts,
                    "dur": max(self._us(at) - ts, 0.0), "tid": tid,
                    "args": args})

    @contextmanager
    def span(self, name: str, tid: str = "sched", **args):
        h = self.begin(name, tid, **args)
        try:
            yield
        finally:
            self.end(h)

    def instant(self, name: str, tid: str = "sched",
                at: Optional[float] = None, **args) -> None:
        if not self.enabled:
            return
        self._push({"name": name, "ph": "i", "ts": self._us(at),
                    "tid": tid, "args": args})

    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self._events) < self.max_events:
            self._events.append(ev)

    # -- export ------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """The completed events, string ``tid``s, ts/dur in µs."""
        return list(self._events)

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: one process, one numeric thread per
        track, ``thread_name`` metadata naming each, ``X``/``i`` events
        sorted by ts — drag the file into https://ui.perfetto.dev."""
        tids: Dict[str, int] = {}
        out: List[Dict[str, Any]] = []
        for ev in sorted(self._events, key=lambda e: e["ts"]):
            t = tids.setdefault(ev["tid"], len(tids))
            out.append({**ev, "pid": 0, "tid": t})
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                 "args": {"name": name}} for name, t in tids.items()]
        # keep the scheduler track above the per-request tracks in the UI
        order = [{"name": "thread_sort_index", "ph": "M", "pid": 0,
                  "tid": t, "args": {"sort_index": t}}
                 for t in tids.values()]
        return {"traceEvents": meta + order + out,
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")


def derive_request_metrics(events) -> Dict[int, Dict[str, float]]:
    """Per-request latency metrics FROM the lifecycle spans (not from any
    side-channel timer): ``{rid: {queue_s, ttft_s, decode_s, tpot_s,
    tokens}}``.

      * ``queue_s``  — the ``queued`` span's duration;
      * ``ttft_s``   — arrival (``queued`` start) to first emitted token
                       (``prefill`` end); equals the scheduler's legacy
                       ``ttft`` dict because both read one clock;
      * ``decode_s`` — summed ``decode`` span durations (preemption
                       splits them);
      * ``tpot_s``   — decode seconds per token after the first;
      * ``tokens``   — from the ``finish`` instant.
    """
    per: Dict[int, Dict[str, float]] = {}
    for ev in events:
        args = ev.get("args", {})
        rid = args.get("rid")
        if rid is None or not str(ev.get("tid", "")).startswith("rid"):
            continue
        d = per.setdefault(int(rid), {"queue_s": 0.0, "ttft_s": 0.0,
                                      "decode_s": 0.0, "tpot_s": 0.0,
                                      "tokens": 0, "_arrive": None,
                                      "_first": None})
        if ev["ph"] == "i" and ev["name"] == "finish":
            d["tokens"] = int(args.get("tokens", 0))
            continue
        if ev["ph"] != "X":
            continue
        if ev["name"] == "queued":
            d["queue_s"] += ev["dur"] / 1e6
            d["_arrive"] = ev["ts"] if d["_arrive"] is None \
                else min(d["_arrive"], ev["ts"])
        elif ev["name"] == "prefill":
            end = ev["ts"] + ev["dur"]
            d["_first"] = end if d["_first"] is None \
                else max(d["_first"], end)
        elif ev["name"] == "decode":
            d["decode_s"] += ev["dur"] / 1e6
    for d in per.values():
        if d["_arrive"] is not None and d["_first"] is not None:
            d["ttft_s"] = (d["_first"] - d["_arrive"]) / 1e6
        if d["tokens"] > 1:
            d["tpot_s"] = d["decode_s"] / (d["tokens"] - 1)
        del d["_arrive"], d["_first"]
    return per


def span_coverage(events, tid_prefix: str = "sched") -> float:
    """Fraction of the wall-clock window between the FIRST admission
    (earliest ``prefill`` lifecycle span start) and the LAST finish
    (latest lifecycle span end) that is covered by the union of the
    ``tid_prefix`` track's spans — the acceptance handle for "the trace
    accounts for where the time went" (>= 0.95 gated in the ``obs`` CI
    smoke and ``tests/test_obs.py``)."""
    window: List[float] = []
    spans: List[Tuple[float, float]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        tid = str(ev.get("tid", ""))
        if tid.startswith("rid"):
            if ev["name"] == "prefill":
                window.append(ev["ts"])
            window.append(ev["ts"] + ev["dur"])
        if tid.startswith(tid_prefix):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
    if not window or not spans:
        return 0.0
    t0, t1 = min(window), max(window)
    if t1 <= t0:
        return 1.0
    covered, cur0, cur1 = 0.0, None, None
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in spans):
        if e <= s:
            continue
        if cur1 is None or s > cur1:
            covered += 0.0 if cur1 is None else cur1 - cur0
            cur0, cur1 = s, e
        else:
            cur1 = max(cur1, e)
    if cur1 is not None:
        covered += cur1 - cur0
    return covered / (t1 - t0)
