"""The training path's spans and counters, on the CPU: ``obs.profiler``'s
one switch and ``span``, the registry's deferred device samples,
``Engine.step``'s and the ``ShardedLoader``'s spans under a profiler the
test opens itself (as the benchmark's traced window does), the kernel
builds' counters, and the training launcher's ``--metrics-out``.

A tiny stacked Dom-ST engine (the smoke variant, two watersheds) and a
tiny mamba2 engine (the smoke variant, block remat) stand in for the
benchmark's cells. No jax: nothing here compares with the reference.
"""
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import TrainConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.tokens import TokenSource  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import MetricRegistry, profiler  # noqa: E402
from repro_torch.obs import registry as obs_registry  # noqa: E402
from repro_torch.train import Engine  # noqa: E402

PHASES = ("engine.step", "engine.forward", "engine.backward",
          "engine.optimizer")
WORKER = ("loader.host_batch", "loader.place")
R = 2


class _DomstSource:
    """Stacked Dom-ST batches of ``R`` watersheds, drawn from the step."""

    steps_per_epoch = None

    def __init__(self, dc, batch=4):
        self.dc, self.batch = dc, batch

    def host_batch(self, step):
        rng = np.random.default_rng(step)
        T, P, B = self.dc.window_days, self.dc.num_pixels, self.batch
        return {
            "precip": rng.gamma(0.8, 1.0, (R, B, T, P)).astype(np.float32),
            "dist": np.broadcast_to(rng.uniform(0, 1, (R, 1, P)),
                                    (R, B, P)).astype(np.float32),
            "target_day": rng.gamma(0.8, 1.0, (R, B, P)).astype(np.float32),
            "discharge": rng.normal(0, 1, (R, B)).astype(np.float32)}


def _domst(registry, accum=1):
    cfg = smoke_variant(get_config("domst"))
    tc = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=1)
    eng = Engine.for_domst(cfg, tc, stacked=True, accum_steps=accum,
                           device="cpu", registry=registry)
    state = eng.init_state(domst.init(cfg, torch.Generator().manual_seed(0),
                                      R))
    return eng, state, _DomstSource(cfg.domst)


def _mamba2(registry, accum=1):
    cfg = smoke_variant(get_config("mamba2-130m"))
    tc = TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=1,
                     remat="block")
    eng = Engine.for_lm(cfg, tc, accum_steps=accum, device="cpu",
                        registry=registry)
    state = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(0)))
    return eng, state, TokenSource(cfg, 4, 32, seed=0)


ENGINES = {"domst": _domst, "mamba2": _mamba2}


def _run(make, registry, steps=3, accum=1, prefetch=2):
    """``steps`` loader-fed steps; (losses, final params)."""
    eng, state, source = make(registry, accum)
    losses = []
    for batch in ShardedLoader(source, eng, prefetch=prefetch,
                               num_steps=steps):
        state, m = eng.step(state, batch)
        losses.append(m["loss"])
    return losses, state.params


# ---------------------------------------------------------------------------
# The switch
# ---------------------------------------------------------------------------
def test_active_only_under_a_window_a_profiler_or_recording(tmp_path):
    assert not profiler.active()
    with profiler.recording():
        assert profiler.active()
        with profiler.recording():
            assert profiler.active()
        assert profiler.active()
    assert not profiler.active()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiler.active()
    assert not profiler.active()
    with profiler.profile(str(tmp_path)):
        assert profiler.active()
    assert not profiler.active() and (tmp_path / "trace.json").exists()


def test_a_span_off_records_nothing_and_on_its_host_seconds():
    reg = MetricRegistry()
    with profiler.span("x.off", reg), profiler.annotate("x.off"):
        pass
    assert reg.snapshot() == {}
    with profiler.recording():
        for _ in range(3):
            with profiler.span("x.on", reg, torch.device("cpu")):
                pass
    snap = reg.snapshot()
    assert list(snap) == ["x.on_s"] and snap["x.on_s"]["count"] == 3


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_steps_with_tracing_off_record_nothing(name):
    reg = MetricRegistry()
    assert not profiler.active()
    losses, _ = _run(ENGINES[name], reg, steps=2)
    assert len(losses) == 2 and reg.snapshot() == {}


# ---------------------------------------------------------------------------
# The spans on the profiler's timeline
# ---------------------------------------------------------------------------
def _ranges(prof):
    """(name, start ns, end ns, thread) of the profiler's host ranges."""
    from torch.autograd import DeviceType
    return [(e.name(), int(e.start_ns()),
             int(e.start_ns()) + int(e.duration_ns()),
             int(e.start_thread_id()))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def _profile(all_threads=False):
    """A profiler as the benchmark's traced window opens one; with
    ``all_threads`` also recording threads it was not started on."""
    from torch._C._profiler import _ExperimentalConfig
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(
            profile_all_threads=all_threads))


@pytest.mark.parametrize("all_threads", [False, True])
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_spans_nest_on_their_threads_under_a_profiler(name, all_threads):
    """The step's phases nest in ``engine.step`` on the consumer's
    thread, beside ``loader.wait``; the worker's spans record in the
    registry under any profiler, and show on the timeline, on the
    worker's thread, where the profiler records every thread."""
    reg = MetricRegistry()
    with _profile(all_threads) as prof:
        _run(ENGINES[name], reg, steps=2)
    ranges = _ranges(prof)
    by = {n: [r for r in ranges if r[0] == n]
          for n in PHASES + WORKER + ("loader.wait",)}
    assert len(by["engine.step"]) == 2
    assert len(by["engine.forward"]) == len(by["engine.backward"]) == 2
    assert len(by["engine.optimizer"]) == 2 and len(by["loader.wait"]) == 2
    main = {r[3] for r in by["engine.step"]}
    assert len(main) == 1
    steps = by["engine.step"]
    for n in PHASES[1:]:
        for _, a, b, t in by[n]:
            assert t in main
            assert any(a0 <= a and b <= b1 for _, a0, b1, _ in steps), n
    assert {r[3] for r in by["loader.wait"]} == main
    if all_threads:
        for n in WORKER:
            assert len(by[n]) == 2
            assert {r[3] for r in by[n]}.isdisjoint(main), n
    # the same spans in the registry, host seconds (no device here)
    snap = reg.snapshot()
    for n in PHASES + WORKER + ("loader.wait",):
        assert snap[f"{n}_s"]["count"] == 2, n
        assert f"{n}_device_s" not in snap
    assert snap["engine.steps"] == 2 and snap["engine.microbatches"] == 2
    assert snap["loader.ready"]["count"] == 2
    assert snap["loader.h2d_bytes"] == snap["loader.h2d_pageable_bytes"] > 0


def test_the_synchronous_loader_waits_on_the_consumers_thread():
    reg = MetricRegistry()
    with _profile() as prof:
        _run(_domst, reg, steps=2, prefetch=0)
    ranges = _ranges(prof)
    waits = [r for r in ranges if r[0] == "loader.wait"]
    main = {r[3] for r in ranges if r[0] == "engine.step"}
    assert len(waits) == 2 and {r[3] for r in waits} == main
    for n in WORKER:        # the placement itself, inside each wait
        inner = [r for r in ranges if r[0] == n]
        assert len(inner) == 2 and {r[3] for r in inner} == main
        assert all(any(a0 <= a and b <= b1 for _, a0, b1, _ in waits)
                   for _, a, b, _ in inner)
    snap = reg.snapshot()
    assert snap["loader.ready"]["max"] == 0


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_accumulation_records_a_forward_and_backward_a_microbatch(name):
    reg = MetricRegistry()
    with profiler.recording():
        _run(ENGINES[name], reg, steps=3, accum=2)
    snap = reg.snapshot()
    assert snap["engine.step_s"]["count"] == 3
    assert snap["engine.forward_s"]["count"] == 6
    assert snap["engine.backward_s"]["count"] == 6
    assert snap["engine.optimizer_s"]["count"] == 3
    assert snap["engine.steps"] == 3 and snap["engine.microbatches"] == 6


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_tracing_changes_no_bit(name):
    off_l, off_p = _run(ENGINES[name], MetricRegistry())
    with profiler.recording(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on_l, on_p = _run(ENGINES[name], MetricRegistry())
    for a, b in zip(off_l, on_l):
        assert torch.equal(a, b)
    assert off_p.keys() == on_p.keys()
    for k in off_p:
        assert torch.equal(off_p[k], on_p[k]), k


def test_eval_step_span():
    reg = MetricRegistry()
    eng, state, source = _domst(reg)
    batch = eng.place_batch(source.host_batch(0))
    eng.eval_step(state, batch)
    assert reg.snapshot() == {}
    with profiler.recording():
        eng.eval_step(state, batch)
    assert reg.snapshot()["engine.eval_step_s"]["count"] == 1


# ---------------------------------------------------------------------------
# Device seconds: deferred, never waited for inside a step
# ---------------------------------------------------------------------------
class _Event:
    """A stand-in CUDA event: complete once the test says so."""

    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done, self.at = False, None

    def record(self, stream=None):
        self.at = len(_Event.log)
        _Event.log.append(("record", self))

    def query(self):
        return self.done

    def synchronize(self):          # one stream: every earlier event too
        for op, e in list(_Event.log):
            if op == "record" and e.at <= self.at:
                e.done = True
        _Event.log.append(("synchronize", self))

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time on an event not passed"
        return float(end.at - self.at)          # ms


@pytest.fixture
def fake_cuda(monkeypatch):
    _Event.log = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    return _Event


def test_device_seconds_wait_for_nothing_until_flushed(fake_cuda):
    reg = MetricRegistry()
    cuda = torch.device("cuda", 0)
    with profiler.recording():
        with profiler.span("a", reg, cuda):
            with profiler.span("b", reg, cuda):
                pass
        events = [e for _, e in fake_cuda.log]
        assert len(events) == 4
        with profiler.span("c", reg, cuda):      # polls: nothing passed
            pass
    assert not any(op == "synchronize" for op, _ in fake_cuda.log)
    assert set(reg._hists) == {"a_s", "b_s", "c_s"}
    for e in events:                              # the device passes a, b
        e.done = True
    reg.poll()
    assert reg.histogram("a_device_s").count == 1
    assert reg.histogram("b_device_s").count == 1
    assert reg.histogram("b_device_s").last == pytest.approx(1e-3)
    assert reg.histogram("a_device_s").last == pytest.approx(3e-3)
    assert "c_device_s" not in reg._hists
    assert not any(op == "synchronize" for op, _ in fake_cuda.log)
    snap = reg.snapshot()                         # a reader flushes
    assert snap["c_device_s"]["count"] == 1
    assert any(op == "synchronize" for op, _ in fake_cuda.log)
    assert reg._deferred == []


def test_a_host_only_span_records_no_events(fake_cuda):
    reg = MetricRegistry()
    with profiler.recording(), profiler.span("h", reg):
        pass
    assert fake_cuda.log == [] and list(reg.snapshot()) == ["h_s"]


# ---------------------------------------------------------------------------
# The registry across threads, and the process-wide one
# ---------------------------------------------------------------------------
def test_spans_from_many_threads_lose_no_sample():
    reg = MetricRegistry()
    n_threads, n = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiler.recording():
            def work(i):
                for _ in range(n):
                    with profiler.span(f"t.{i % 2}", reg):
                        reg.add("t.count")
            ts = [threading.Thread(target=work, args=(i,))
                  for i in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = reg.snapshot()
    assert snap["t.count"] == n_threads * n
    assert snap["t.0_s"]["count"] == snap["t.1_s"]["count"] \
        == n_threads * n // 2


def test_engines_default_to_the_process_registry():
    mine = MetricRegistry()
    assert Engine.for_domst(smoke_variant(get_config("domst")),
                            TrainConfig(), device="cpu").registry \
        is obs_registry.default()
    with obs_registry.as_default(mine):
        assert obs_registry.default() is mine
        assert Engine.for_domst(smoke_variant(get_config("domst")),
                                TrainConfig(), device="cpu").registry is mine
    assert obs_registry.default() is not mine


# ---------------------------------------------------------------------------
# Kernel builds, with a stand-in nvcc
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` that writes its ``-o`` file, and a build directory of
    the test's own."""
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                   "echo lib > \"$2\"\n")
    exe.chmod(0o755)
    monkeypatch.setattr(build, "nvcc", lambda: str(exe))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")


def test_builds_count_built_and_found_tracing_off(fake_nvcc):
    reg = MetricRegistry()
    assert not profiler.active()
    with obs_registry.as_default(reg):
        build.build(("pixcon", "conv1d"))
        build.build(("pixcon",))
    snap = reg.snapshot()
    assert snap["kernels.built.pixcon"] == snap["kernels.built.conv1d"] == 1
    assert snap["kernels.found.pixcon"] == 1
    assert "kernels.found.conv1d" not in snap
    assert snap["kernels.build_s"]["count"] == 2


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
WANT = {"engine.forward_s", "engine.backward_s", "engine.optimizer_s",
        "engine.step_s", "train.step_s", "loader.wait_s", "loader.h2d_bytes",
        "loader.h2d_pageable_bytes", "loader.host_batch_s", "loader.place_s",
        "loader.ready", "engine.steps", "engine.microbatches"}
GONE = {"train.loader_wait_s", "train.loader_wait_last_s"}


def _names(path):
    return {json.loads(line)["name"] for line in open(path)}


def test_train_cli_metrics_out_domst(tmp_path, monkeypatch, fake_nvcc):
    """A Dom-ST run's dump holds the engine's, the loader's and (a build
    run inside the run) the kernels' entries; the result keeps its
    step-time and loader-wait keys."""
    real = ttrain.make_domst_windows

    def windows_after_a_build(*a, **kw):
        build.build(("pixcon",))
        return real(*a, **kw)
    monkeypatch.setattr(ttrain, "make_domst_windows", windows_after_a_build)
    out = tmp_path / "m.jsonl"
    before = obs_registry.default()
    res = ttrain.main(["--arch", "domst", "--watersheds", "2", "--days",
                       "150", "--epochs", "1", "--device", "cpu",
                       "--eval-interval", "1", "--metrics-out", str(out)])
    assert obs_registry.default() is before and not profiler.active()
    names = _names(out)
    assert WANT | {"engine.eval_step_s", "kernels.build_s",
                   "kernels.built.pixcon"} <= names
    assert not names & GONE
    assert {"step_p50_s", "loader_wait_p99_s", "loader_wait_s"} <= res.keys()
    assert res["loader_wait_s"] >= 0 and res["step_p50_s"] > 0
    assert "kernels.built.pixcon" not in before.snapshot()


def test_train_cli_metrics_out_lm(tmp_path):
    """An LM run's dump, and its ``--profile-dir`` trace with the spans of
    both threads."""
    out = tmp_path / "m.jsonl"
    res = ttrain.main(["--arch", "mamba2-130m", "--smoke", "--steps", "3",
                       "--batch-size", "4", "--seq-len", "24", "--device",
                       "cpu", "--accum-steps", "2", "--metrics-out", str(out),
                       "--profile-dir", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    tids = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            tids.setdefault(e["name"], set()).add(e["tid"])
    for n in PHASES + WORKER + ("loader.wait",):
        assert n in tids, n
    assert len(tids["engine.step"]) == 1
    assert tids["loader.wait"] == tids["engine.step"]
    assert tids["loader.host_batch"].isdisjoint(tids["engine.step"])
    lines = {json.loads(line)["name"]: json.loads(line) for line in open(out)}
    assert WANT <= lines.keys() and not lines.keys() & GONE
    assert not any(n.startswith("kernels.") for n in lines)   # none built
    assert lines["engine.forward_s"]["count"] == 6
    assert lines["loader.wait_s"]["count"] == 3
    assert lines["train.step_s"]["count"] == 3
    assert res["loader_wait_s"] == pytest.approx(
        lines["loader.wait_s"]["sum"], abs=1e-6)
