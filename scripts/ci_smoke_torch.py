"""Serve-CLI smoke checks of the PyTorch port: ``scripts/ci_smoke.py``'s four
subcommands, each driving ``repro_torch.launch.serve`` end to end with the
same queues and asserting the same reproducibility bar.

  PYTHONPATH=src python scripts/ci_smoke_torch.py prefix
  PYTHONPATH=src python scripts/ci_smoke_torch.py sampling
  PYTHONPATH=src python scripts/ci_smoke_torch.py host-tier
  PYTHONPATH=src python scripts/ci_smoke_torch.py --device cpu obs --out-dir build/obs

Subcommands:

* ``prefix``    — the same shared-prefix queue served plain and with
                  ``--prefix-cache --preempt`` must emit bit-identical
                  streams, and the cached run must skip prefill work
                  (``prefix_hit_tokens > 0``).
* ``sampling``  — a sampled queue served with speculation on must be
                  reproducible (two runs at the same ``--sample-seed``
                  print the same stream digest) and must sample (every
                  request non-greedy).
* ``host-tier`` — a forced-spill queue (two alternating prefix families
                  on a pool sized below either family) served with and
                  without ``--host-cache-mb`` must emit bit-identical
                  streams; the host-tier run must record
                  ``prefix_hit_tokens > 0`` and ``prefill_skipped_pct >
                  0`` where the run without one records 0.
* ``obs``       — the same queue served with and without
                  ``--trace-out/--metrics-out`` must emit bit-identical
                  streams; the trace must be valid Chrome trace-event
                  JSON whose spans cover >= 95% of the serve window, and
                  the span-derived TTFTs must match the ``serve.ttft_s``
                  series in the metrics JSONL within 1 ms. Artifacts
                  land in ``--out-dir``.

Every check takes the way it runs the CLI as its ``run`` argument:
``run_serve`` (the default, and this script's own) starts the CLI in a
subprocess; ``run_in_process`` calls ``launch/serve.py::main`` in this
process. ``--device`` (default ``cuda``) is passed to every run.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _parse(out: str):
    """The CLI's stdout -> (parsed JSON doc, ``req N: ...`` lines)."""
    lines = out.strip().splitlines()
    doc = json.loads([ln for ln in lines if ln.startswith("{")][0])
    streams = [ln for ln in lines if ln.startswith("req ")]
    return doc, streams


def run_serve(extra, base=None):
    """Run the serve CLI in a subprocess; return (doc, stream lines)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"] + (base or []) + extra
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        cmd, check=True, capture_output=True, text=True, env=env
    ).stdout
    return _parse(out)


def run_in_process(extra, base=None):
    """Run the serve CLI's ``main`` in this process; return (doc, stream
    lines)."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.launch.serve import main as serve_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_main((base or []) + extra)
    return _parse(buf.getvalue())


def _base(args, *flags):
    return ["--arch", args.arch, "--smoke", "--device", args.device, *flags]


def smoke_prefix(args, run=run_serve) -> dict:
    base = _base(args, "--requests", "4")
    base += ["--batch-size", "2", "--prompt-len", "24", "--gen", "8"]
    base += ["--page-size", "8", "--shared-prefix", "18"]
    plain_doc, plain_streams = run([], base)
    cache_doc, cache_streams = run(["--prefix-cache", "--preempt"], base)
    assert cache_streams == plain_streams, (plain_streams, cache_streams)
    assert cache_doc["prefix_hit_tokens"] > 0, cache_doc
    keys = "prefix_hits prefix_hit_tokens prefix_hit_rate cow_pages".split()
    keys += ["preemptions", "restores"]
    got = {k: cache_doc[k] for k in keys}
    print("prefix-cache parity ok:", got)
    return got


def smoke_sampling(args, run=run_serve) -> dict:
    base = _base(args, "--requests", "4")
    base += ["--batch-size", "2", "--prompt-len", "12", "--gen", "8", "--ragged"]
    base += ["--temperature", "0.8", "--top-p", "0.9"]
    base += ["--spec-k", "4", "--sample-seed", "7"]

    def digest():
        doc, _ = run([], base)
        assert doc["sampled_requests"] == 4, doc
        return doc["stream_digest"]

    a, b = digest(), digest()
    assert a == b, (a, b)
    print("sampled serve reproducible, digest", a)
    return {"stream_digest": a}


def write_spill_queue(path, families=2, per_family=2, prefix_len=16, tail_len=8):
    """An alternating multi-family queue: request i uses family i %
    ``families``. Served one slot at a time on a pool that fits one
    request, each admission reclaims the previous family's cached pages;
    with a host tier those pages spill and the family's next request
    restores them; without one the cache contributes nothing."""
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 512, prefix_len).tolist() for _ in range(families)]
    entries = []
    for i in range(families * per_family):
        tail = rng.integers(0, 512, tail_len).tolist()
        entries.append({"prompt": prefixes[i % families] + tail})
    with open(path, "w") as f:
        json.dump(entries, f)


def smoke_host_tier(args, run=run_serve) -> dict:
    fd, qpath = tempfile.mkstemp(suffix=".json", prefix="ci_spill_queue_")
    os.close(fd)
    try:
        write_spill_queue(qpath)
        # prompt 24 @ page 8 + gen 8 -> 4 pages/request == the whole pool:
        # every admission must reclaim the previous request's cached pages
        base = _base(args, "--batch-size", "1")
        base += ["--gen", "8", "--page-size", "8", "--num-pages", "4"]
        base += ["--queue", qpath, "--prefix-cache"]
        cold_doc, cold_streams = run([], base)
        mb = str(args.host_cache_mb)
        host_doc, host_streams = run(["--host-cache-mb", mb], base)
        assert host_streams == cold_streams, (cold_streams, host_streams)
        assert host_doc["stream_digest"] == cold_doc["stream_digest"]
        # without a host tier the forced-spill queue cannot hit at all
        assert cold_doc["prefix_hit_tokens"] == 0, cold_doc
        assert cold_doc["prefill_skipped_pct"] == 0, cold_doc
        # with one, the spilled prefix pages come back as real hits
        assert host_doc["prefix_hit_tokens"] > 0, host_doc
        assert host_doc["prefill_skipped_pct"] > 0, host_doc
        assert host_doc["host_hits"] > 0, host_doc
        assert host_doc["host_spilled_pages"] > 0, host_doc
        keys = "prefix_hit_tokens prefill_skipped_pct host_hits".split()
        keys += ["host_hit_tokens", "host_restored_pages", "host_spilled_pages"]
        got = {k: host_doc[k] for k in keys}
        print("host-tier parity ok:", got)
        return got
    finally:
        os.unlink(qpath)


def smoke_obs(args, run=run_serve) -> dict:
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.obs.trace import derive_request_metrics, span_coverage

    os.makedirs(args.out_dir, exist_ok=True)
    trace_path = os.path.join(args.out_dir, "trace.json")
    metrics_path = os.path.join(args.out_dir, "metrics.jsonl")
    base = _base(args, "--requests", "4")
    base += ["--batch-size", "2", "--prompt-len", "24", "--gen", "8"]
    base += ["--prefill-chunk", "8"]
    plain_doc, plain_streams = run([], base)
    flags = ["--trace-out", trace_path, "--metrics-out", metrics_path]
    obs_doc, obs_streams = run(flags, base)
    # observability must be a pure observer: bit-identical streams
    assert obs_streams == plain_streams, (plain_streams, obs_streams)
    assert obs_doc["stream_digest"] == plain_doc["stream_digest"]

    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    assert spans, "trace has no complete spans"
    for e in spans:  # Chrome trace-event schema: ints + complete-span fields
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int), e
        assert "name" in e and "ts" in e and e["dur"] >= 0, e
    # undo the Chrome int-tid mapping so the repro_torch.obs helpers apply
    tid_name = {
        e["tid"]: e["args"]["name"]
        for e in events
        if e.get("ph") == "M" and e.get("name") == "thread_name"
    }
    raw = [
        dict(e, tid=tid_name.get(e["tid"], str(e["tid"])))
        for e in events
        if e.get("ph") in ("X", "i")
    ]
    for e in raw:
        if e["ph"] == "X" and e["tid"].startswith("rid"):
            assert "rid" in e["args"], e

    cov = span_coverage(raw)
    assert cov >= 0.95, f"span coverage {cov:.3f} < 0.95"
    per = derive_request_metrics(raw)
    assert len(per) == 4, sorted(per)

    with open(metrics_path) as f:
        rows = [json.loads(ln) for ln in f]
    ttft_rows = [d for d in rows if d.get("name") == "serve.ttft_s"]
    assert ttft_rows, "metrics JSONL lacks the serve.ttft_s series"
    # span-derived TTFT vs the per-request series: within 1 ms
    for d in ttft_rows:
        rid = int(d["label"])
        assert abs(per[rid]["ttft_s"] - d["value"]) < 1e-3, (rid, d, per[rid])
    vals = [d["value"] for d in ttft_rows]
    assert abs(float(np.percentile(vals, 50)) - obs_doc["ttft_p50_s"]) < 1e-3
    gap = [d for d in rows if d.get("name") == "serve.decode_gap_s"]
    assert gap and gap[0]["count"] > 0, gap
    got = {
        "spans": len(spans),
        "coverage": round(cov, 4),
        "ttft_p50_s": obs_doc["ttft_p50_s"],
        "decode_gap_p99_s": obs_doc["decode_gap_p99_s"],
    }
    print("obs smoke ok:", got)
    return got


CHECKS = {
    "prefix": smoke_prefix,
    "sampling": smoke_sampling,
    "host-tier": smoke_host_tier,
    "obs": smoke_obs,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b", help="arch for every smoke")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every run; 'cpu' runs the plain versions")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("prefix", help="prefix-cache + preemption CLI parity")
    sub.add_parser("sampling", help="sampled serve reproducibility")
    ht = sub.add_parser("host-tier", help="forced-spill host-tier CLI parity")
    ht.add_argument("--host-cache-mb", type=float, default=64.0)
    ob = sub.add_parser("obs", help="trace/metrics schema + digest parity")
    ob.add_argument("--out-dir", default="obs-artifacts")
    return ap


def main(argv=None, run=run_serve) -> dict:
    args = build_parser().parse_args(argv)
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.device import resolve_device

    resolve_device(args.device)  # raises before any run without a card
    return CHECKS[args.cmd](args, run=run)


if __name__ == "__main__":
    main()
