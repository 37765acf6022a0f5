"""Optional ``torch.profiler`` integration, the port of the reference's
``repro/obs/profiler.py`` (which wraps ``jax.profiler``).

Three pieces, all inert unless :func:`active`:

  * :func:`start` / :func:`stop` / :func:`profile` — a ``torch.profiler``
    trace (CPU and, with a card, CUDA activity, of every thread) written
    as Chrome trace-event JSON to ``<dir>/trace.json`` when the window
    closes, so ``--profile-dir`` on either launcher captures a device
    timeline (open it in ui.perfetto.dev or chrome://tracing);
  * :func:`annotate` — a ``torch.profiler.record_function`` scope, plus
    an NVTX range on a card, that the engines place around their steps,
    so host phase names line up with the device timeline;
  * :func:`span` — such a range that also records its host seconds in a
    ``MetricRegistry`` (``<name>_s``) and, on a CUDA device, its device
    seconds (``<name>_device_s``) from a pair of CUDA events on the
    current stream, which the registry reads once the device has passed
    them (``MetricRegistry.poll`` at each later span, ``flush`` when it is
    read): a span never makes the host wait for the device.

:func:`active` is one switch: true while this module's window is open,
while any ``torch.profiler`` records (the benchmark's traced window
opens its own), or inside :func:`recording` (a launcher's run). When it
is false an annotation or a span costs that one check and records
nothing, so neither ever perturbs a stream.

One window at a time: the profiler traces the whole process.
"""
from __future__ import annotations

import os
import time
from contextlib import ExitStack, contextmanager, nullcontext

import torch
import torch.autograd.profiler as _autograd_profiler

_window = None      # (profiler, trace path) while a window is open
_recording = 0      # open recording() blocks
_NULL = nullcontext()


def active() -> bool:
    """Whether annotations and spans record: any open ``torch.profiler``
    (this module's window is one), or a :func:`recording` block."""
    return _recording > 0 or _autograd_profiler._is_profiler_enabled


@contextmanager
def recording():
    """Spans record into their registries for the block, with no profiler
    open (a launcher's run, whose result reports what they measure)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def start(profile_dir: str) -> None:
    """Open a ``torch.profiler`` window writing to ``profile_dir``."""
    global _window
    if _window is not None:
        raise RuntimeError("a profile window is already open")
    from torch._C._profiler import _ExperimentalConfig
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    # every thread: the loader's worker places batches beside the step
    prof = torch.profiler.profile(
        activities=acts,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    _window = (prof, os.path.join(profile_dir, "trace.json"))


def stop() -> None:
    """Close the window and write its trace; a no-op when none is open."""
    global _window
    if _window is None:
        return
    prof, path = _window
    _window = None
    prof.stop()
    prof.export_chrome_trace(path)


@contextmanager
def profile(profile_dir=None):
    """Profile window for the duration of the block when ``profile_dir``
    is set; no-op otherwise — lets launchers write
    ``with profiler.profile(args.profile_dir): ...`` unconditionally."""
    if not profile_dir:
        yield
        return
    start(profile_dir)
    try:
        yield
    finally:
        stop()


def annotate(name: str):
    """``record_function(name)`` (and an NVTX range on a card) while
    :func:`active`, else a null context."""
    if not active():
        return _NULL
    stack = ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack


def span(name: str, registry, device=None):
    """While :func:`active`: ``record_function(name)``, its host seconds
    as a sample of ``registry``'s histogram ``<name>_s`` and, when
    ``device`` is a CUDA device, an NVTX range and the device seconds
    between two events on its current stream as a deferred sample of
    ``<name>_device_s``. Else a null context."""
    if not active():
        return _NULL
    return _Span(name, registry,
                 device if device is not None and device.type == "cuda"
                 else None)


class _Span:
    __slots__ = ("name", "registry", "device", "range", "start", "t0")

    def __init__(self, name, registry, device):
        self.name, self.registry, self.device = name, registry, device

    def __enter__(self):
        self.registry.poll()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if self.device is not None:
            torch.cuda.nvtx.range_push(self.name)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.device is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            torch.cuda.nvtx.range_pop()
            self.registry.defer(f"{self.name}_device_s", self.start, end)
        self.range.__exit__(*exc)
        self.registry.record(f"{self.name}_s", dt)
        return False
