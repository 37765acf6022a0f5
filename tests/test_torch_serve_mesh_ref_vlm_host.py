"""The VLM and the host tier as served on a mesh, held to the reference.

The float32 runs of ``torch_mesh_archs.mesh_runs`` for internvl2-2b with
8-patch images (the gate off and on; chunks of 3 and speculative) and
for the host tier (qwen2-1.5b and recurrentgemma-2b, two prefix families
on a pool of one request): ``test_torch_serve_mesh_archs.py`` serves each
on a (2, 2) gloo mesh and holds its streams and counts (the serving
policies' too) to the same run dict served by the port on one device.
Here that one-device run is served again, in this process, and each
queue through the reference's engine and scheduler on one device from
the reference's init params. The port's streams and counts must equal
the reference's: with the mesh's equal to the port's, a fault that the
port's one-device path shares with its mesh path shows here.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_harness as harness  # noqa: E402
import torch_mesh_archs as runs_of  # noqa: E402
import torch_serve_parity as parity  # noqa: E402

torch.set_num_threads(1)
NAMES = (runs_of.VLM, *runs_of.HOST_ARCHS)
_GOT = {}


def _served():
    """{key: (the port's one-device result, the reference's (streams,
    stats))}."""
    if not _GOT:
        keys, runs = runs_of.mesh_runs(NAMES)
        port = harness.serve_all(runs)
        ref = {}
        for key, run in zip(keys, runs):
            truth = ref[keys[run["drafter"][2]]][0] \
                if run.get("drafter") else None
            ref[key] = runs_of.serve_ref(run, truth=truth)
        _GOT.update({k: (p, ref[k]) for k, p in zip(keys, port)})
    return _GOT


@pytest.mark.parametrize("spec", [False, True], ids=["chunked", "spec"])
@pytest.mark.parametrize("gate", [False, True], ids=["gate-off", "gate-on"])
def test_vlm_mesh_runs_equal_reference(gate, spec):
    key = (runs_of.VLM, f"gate {gate}" + (" spec" if spec else ""))
    port, (want, want_stats) = _served()[key]
    assert port["streams"] == want
    for k in parity.STAT_KEYS:
        assert port["stats"][k] == want_stats[k], k
    if spec:
        assert want_stats["spec_accepted"] > 0


@pytest.mark.parametrize("arch", runs_of.HOST_ARCHS)
def test_host_tier_mesh_runs_equal_reference(arch):
    port, (want, want_stats) = _served()[(arch, "host tier")]
    assert port["streams"] == want
    for k in parity.POLICY_KEYS + parity.STAT_KEYS:
        assert port["stats"][k] == want_stats[k], k
    assert want_stats["host_hits"] >= 2
    assert want_stats["host_restored_pages"] >= 4
