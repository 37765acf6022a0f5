"""mamba2 and the MoE decoders as served on a mesh, held to the reference.

The float32 runs of ``torch_mesh_archs.mesh_runs`` for mamba2-130m, its
3-head variant and both MoE decoders at an ample capacity (4 experts,
top 2): ``test_torch_serve_mesh_archs.py`` serves each on a (2, 2) gloo
mesh and holds its streams and counts, stream for stream, to the same run
dict served by the port on one device. Here that one-device run is served
again, in this process, and each queue through the reference's engine and
scheduler on one device from the reference's init params (the contiguous
engine where the run's is; a scripted drafter proposing the reference's
own streams, right on two tokens in three). The port's streams and
scheduler counts must equal the reference's: with the mesh's equal to the
port's, a fault that the port's one-device path shares with its mesh
path shows here.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_harness as harness  # noqa: E402
import torch_mesh_archs as runs_of  # noqa: E402
import torch_serve_parity as parity  # noqa: E402

torch.set_num_threads(1)
NAMES = (runs_of.MAMBA, "few-heads", *runs_of.MOE)
_GOT = {}


def _served():
    """{key: (the port's one-device result, the reference's (streams,
    stats))}."""
    if not _GOT:
        keys, runs = runs_of.mesh_runs(NAMES, float64=False)
        port = harness.serve_all(runs)
        ref = {}
        for key, run in zip(keys, runs):
            truth = ref[keys[run["drafter"][2]]][0] \
                if run.get("drafter") else None
            ref[key] = runs_of.serve_ref(run, truth=truth)
        _GOT.update({k: (p, ref[k]) for k, p in zip(keys, port)})
    return _GOT


@pytest.mark.parametrize("name", [runs_of.MAMBA, "few-heads"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "spec"])
def test_mamba2_mesh_runs_equal_reference(name, kind):
    port, (want, want_stats) = _served()[(name, kind)]
    assert port["streams"] == want
    for key in parity.STAT_KEYS:
        assert port["stats"][key] == want_stats[key], key
    if kind == "spec":
        assert 0 < want_stats["spec_accepted"] < want_stats["spec_proposed"]


@pytest.mark.parametrize("kind", ["whole", "paged", "spec"])
@pytest.mark.parametrize("arch", runs_of.MOE)
def test_moe_mesh_runs_equal_reference(arch, kind):
    port, (want, want_stats) = _served()[(arch, kind)]
    assert port["streams"] == want
    for key in parity.STAT_KEYS:
        assert port["stats"][key] == want_stats[key], key
    if kind == "paged":
        assert want_stats["prefill_chunks"] > 0
