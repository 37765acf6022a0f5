"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled
on its own by ``nvcc`` into ``build/repro_torch/lib<name>-<hash>.so`` at
the root of the checkout (a directory ``.gitignore`` lists). The hash
covers the source, the shared headers and the flags, so an edit rebuilds.
``build()`` starts one ``nvcc`` for every missing library at once and
waits for all of them. No PyTorch headers are compiled, so a build takes
seconds, and nothing here needs ``ninja``.

Each ``build()`` records into the process's registry
(``obs.registry.default()``), tracing on or off, since it runs once a
process: its seconds as a sample of ``kernels.build_s``, and per library
the counter ``kernels.built.<name>`` (``nvcc`` ran) or
``kernels.found.<name>`` (built already).

Nothing is imported or compiled when this module is imported: the CPU
tests import every module of the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from repro_torch.obs import registry as obs_registry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pixcon", "lstm_cell", "paged_attn", "conv1d", "ssd_chunk",
           "local_attn")
# No --use_fast_math: the kernels are held to their plain versions at fp32
# tolerances, and expf/tanhf must stay the accurate library functions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``lib<name>-<hash>.log`` beside the library. Raises if any fails."""
    t0 = time.perf_counter()
    reg = obs_registry.default()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            reg.add(f"kernels.found.{name}")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
        reg.add(f"kernels.built.{name}")
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)      # atomic: a concurrent build is safe
    reg.record("kernels.build_s", time.perf_counter() - t0)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {name: lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, as
    a ``PyDLL``: its calls keep the GIL rather than release and take it
    again, since every launch function returns at once and on the served
    and forecast paths a wrapper's host time is most of a call."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.PyDLL(str(build((name,))[name]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on the ``cudaError_t`` a launch function of ``lib`` returned."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: kernel launch failed: {msg} ({rc})")
