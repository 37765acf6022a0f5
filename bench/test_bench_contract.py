"""``BENCHMARK.json`` and the files it names keep the benchmark's rules;
nothing under ``bench/`` imports JAX or the JAX package, nothing under
``bench/reference/`` imports the port; the trace reduction and the
readers read what they should from a made-up window."""
import ast
import json
import os
import re

import pytest

from bench import harness
from bench.conftest import DOMST, MAMBA2, ROOT

BENCH = os.path.join(ROOT, "bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _spec(pending=False):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    return harness.with_pending(spec) if pending else spec


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_under_bench_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imports(p)) & set(harness.FORBIDDEN))
             for p in _sources()}
    assert not {p: m for p, m in found.items() if m}
    ref = os.path.join(BENCH, "reference")
    port = {p: "repro_torch" for p in _sources()
            if p.startswith(ref) and "repro_torch" in set(_imports(p))}
    assert not port


@pytest.mark.parametrize("pending", [False, True])
def test_benchmark_json_keeps_the_rules(pending):
    """``BENCHMARK.json`` alone, and with the pending cells admitted."""
    spec = _spec(pending)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and spec["command"][1] == "bench/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    for group, keys in KEYS.items():
        entries = spec[group]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names))
        for e in entries:
            assert keys <= set(e) <= keys | {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    configs = {c["name"]: c for c in spec["configs"]}
    cells = {w["name"]: w for w in spec["workloads"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    for c in configs.values():
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("bench/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] \
            == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in cells.values())
    assert all(w["chips"] in (1, 4) for w in cells.values())
    assert four <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]
        for w in m.get("workloads", []):
            assert w in cells
    for name, w in cells.items():
        cell = harness.find_cell(name, spec)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        assert {m["moves"] for m in cell["per_layer"]} <= reported
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))


def _window(units, work_per_step):
    spans = harness.Spans()
    spans.total.update(loader_wait=2.0, dispatch=4.0)
    spans.count.update(loader_wait=10, dispatch=10)
    return {"steps": 10, "seconds": 20.0, "work": 10 * work_per_step,
            "peak_bytes": 3 * 2 ** 30, "spans": spans, "failed": 0}


def _events():
    """A made-up trace: a window of 10 ms; two kernels of each of two
    names, a memcpy that overlaps one; host spans around them."""
    ms = 1_000_000
    return [
        ("bench.traced", False, 0, 10 * ms, 1),
        ("bench.loader_wait", False, 0, 2 * ms, 1),
        ("bench.dispatch", False, 2 * ms, 9 * ms, 1),
        ("aten::mm", False, 3 * ms, 4 * ms, 1),
        ("worker op", False, 0, 10 * ms, 2),
        ("pixcon_gate_kernel", True, 1 * ms, 2 * ms, 0),
        ("pixcon_gate_kernel", True, 5 * ms, 6 * ms, 0),
        ("lstm_cell_kernel<64>", True, 6 * ms, 8 * ms, 0),
        ("Memcpy HtoD", True, 7 * ms, 9 * ms, 0),
        ("lstm_cell_kernel<64>", True, 12 * ms, 13 * ms, 0)]


def test_reduce_trace_on_a_made_up_window():
    tr = harness.reduce_trace(_events())
    assert tr["window_s"] == pytest.approx(0.010)
    assert tr["busy_s"] == pytest.approx(0.005)       # 1-2 and 5-9 ms
    assert harness.kernel_time(tr, "pixcon_gate_kernel") == \
        (2, pytest.approx(0.002))
    assert harness.kernel_time(tr, "lstm_cell_kernel")[0] == 1
    assert harness.kernel_time(tr, "ssd_chunk") is None
    idle = dict((k, v) for k, v in tr["idle_gaps"])
    assert idle == {"loader_wait: bench.loader_wait": pytest.approx(0.001),
                    "dispatch: bench.dispatch": pytest.approx(0.003),
                    "outside: no host op": pytest.approx(0.001)}
    assert len(tr["device_ops"]) == 3
    assert all(s == pytest.approx(0.002) for _, s in tr["device_ops"])


@pytest.mark.parametrize("name", [DOMST, MAMBA2])
def test_readers_read_their_cells(name):
    cell = harness.find_cell(name)
    units = "windows" if name == DOMST else "tokens"
    job = type("Job", (), {"units": units, "work_per_step": 1000})
    ctx = harness.Context(cell, job, _window(units, 1000), 12.5,
                          harness.reduce_trace(_events()))
    for m in cell["end_to_end"] + cell["per_layer"]:
        v = harness.reader(m["name"])(ctx)
        kernel = "roofline" in m["name"]
        absent = kernel and name == MAMBA2       # no such kernel traced
        assert (v is None) == absent, (m["name"], v)
    other = "windows" if units == "tokens" else "tokens"
    spec = _spec(pending=True)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m.get("workloads") and name not in m["workloads"] and \
                "roofline" not in m["name"]:
            ctx.units = units
            assert harness.reader(m["name"])(ctx) is None, m["name"]
    assert other


@pytest.mark.parametrize("only_bench", [True, False])
def test_run_prints_no_result_without_the_port_or_a_card(tmp_path,
                                                          only_bench):
    """From a directory that holds only ``BENCHMARK.json`` and ``bench/``,
    and here, where there is no card, the run exits non-zero and prints
    no result."""
    import shutil
    import subprocess
    import sys
    root = ROOT
    if only_bench:
        root = str(tmp_path)
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
        shutil.copytree(BENCH, os.path.join(root, "bench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", DOMST, "--seed",
         "2147483900", "--seconds", "1", "--trace", "0"], cwd=root, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "no result" in out.stderr
