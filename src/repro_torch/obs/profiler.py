"""Optional ``torch.profiler`` integration, the port of the reference's
``repro/obs/profiler.py`` (which wraps ``jax.profiler``).

Two pieces, both inert unless a profile window is open:

  * :func:`start` / :func:`stop` / :func:`profile` — a ``torch.profiler``
    trace (CPU and, with a card, CUDA activity) written as Chrome
    trace-event JSON to ``<dir>/trace.json`` when the window closes, so
    ``--profile-dir`` on either launcher captures a device timeline (open
    it in ui.perfetto.dev or chrome://tracing);
  * :func:`annotate` — a ``torch.profiler.record_function`` scope, plus
    an NVTX range on a card, that the engines place around their steps,
    so host phase names line up with the device timeline. With no window
    open it returns a null context and costs one attribute read, so
    annotation never perturbs a stream.

One window at a time: the profiler traces the whole process.
"""
from __future__ import annotations

import os
from contextlib import ExitStack, contextmanager, nullcontext

import torch

_window = None      # (profiler, trace path) while a window is open


def active() -> bool:
    return _window is not None


def start(profile_dir: str) -> None:
    """Open a ``torch.profiler`` window writing to ``profile_dir``."""
    global _window
    if _window is not None:
        raise RuntimeError("a profile window is already open")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
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
    """``record_function(name)`` (and an NVTX range on a card) while a
    profile window is open, else a null context."""
    if _window is None:
        return nullcontext()
    stack = ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(name))
    return stack
