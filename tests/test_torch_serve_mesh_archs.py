"""Serving mamba2, the MoE decoders and the VLM on a mesh, the host tier
on a mesh, and the training-to-serving hand-offs on a mesh.

On gloo ranks (``torch_dist_harness.py``), smoke configs, float32 unless
said otherwise:

* mamba2-130m on a (2, 2) mesh, and a variant of it (``d_model`` 48: 96
  inner channels, 3 SSM heads) whose heads do not divide the model axis
  of 2, as mamba2-130m's 24 do not divide 16 (the heads are replicated
  while the inner channels split): contiguous, paged with chunks and
  speculative streams (a scripted drafter) equal one device's; every
  decode step's logits in float64 within 1e-5 of their scale of one
  device's, contiguous and paged (the SSM step, the conv1d and SSD-chunk
  wrappers on local blocks, ``select_verified`` on the mesh).
* qwen3-moe-30b-a3b and deepseek-moe-16b (4 experts, top 2) served
  through ``moe_block_sharded`` (the experts on "model"): on a (1, 2)
  mesh each mode's streams and counts equal the reference's same mode
  at the default capacity (whole; chunks of 3; ``spec_k=3`` with the
  n-gram drafter on damped params, as ``test_torch_serve_moe.py``); on a
  (2, 2) mesh, at an ample capacity (no drops, so the modes agree),
  whole, chunked and speculative streams equal one device's.
* internvl2-2b with 8-patch images, the gate off and on: paged and
  speculative streams equal one device's.
* The host tier on a (2, 2) mesh (qwen2-1.5b and recurrentgemma-2b, two
  prefix families on a pool of one request): ``spill_page`` /
  ``restore_pages`` on local blocks; streams and ``POLICY_KEYS`` counts
  equal one device's, with host hits.
* ``InferenceEngine.from_train_state`` from a (2, 2) training engine of
  mamba2-130m, with and without FSDP: the params adopted on the ranks
  (no ``full_tensor``, no ``host_state``; without FSDP each float32 leaf
  keeps the training block's storage), placed as the serving rules say;
  streams equal the one-device hand-off's; ``ModelDrafter.
  from_checkpoint(..., mesh=)`` of the saved state restores onto the
  same placements and, drafting for the adopted target, has every draft
  accepted and the same streams; both sets of streams equal the
  reference's engine serving the trained params on one device.

One spawn a mesh case (module-level caches); the one-device and the
reference's runs run in the test's own process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_harness as harness  # noqa: E402
import torch_mesh_archs as runs_of  # noqa: E402
import torch_serve_parity as parity  # noqa: E402
from repro.serve import NgramDrafter as JNgram  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.convert import flatten, lm_params_to_jax, unflatten  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import InferenceEngine, Scheduler  # noqa: E402
from repro_torch.train import Engine  # noqa: E402

torch.set_num_threads(1)
MOE, MAMBA, VLM = runs_of.MOE, runs_of.MAMBA, runs_of.VLM
LENS, WHOLE, TC = runs_of.LENS, runs_of.WHOLE, runs_of.TC
_port_tree, _queue = runs_of.port_tree, runs_of.queue


_SPAWNED = {}


def _on_mesh(tmp_path_factory):
    """Every (2, 2) case's result on rank 0 (every rank's streams equal)
    and on one device."""
    if not _SPAWNED:
        keys, runs, got = runs_of.on_mesh(tmp_path_factory)
        one = harness.serve_all(runs)
        _SPAWNED.update({k: (got[k], o) for k, o in zip(keys, one)})
    return _SPAWNED


@pytest.mark.parametrize("name", [MAMBA, "few-heads"])
@pytest.mark.parametrize("kind", ["contiguous", "paged", "spec"])
def test_mamba2_streams_on_mesh_equal_one_device(name, kind,
                                                 tmp_path_factory):
    mesh, one = _on_mesh(tmp_path_factory)[(name, kind)]
    assert mesh["streams"] == one["streams"]
    for key in parity.STAT_KEYS:
        assert mesh["stats"][key] == one["stats"][key], key
    calls = mesh["local_calls"]
    assert calls["conv1d"] > 0          # every SSM path convolves locally
    assert calls["ssm_recurrence"] > 0  # decode (and chunks, verify)
    if kind == "paged":
        assert mesh["stats"]["prefill_chunks"] > 0
    else:
        assert calls["ssd_chunked"] > 0     # whole prefill: the SSD scan
    if kind == "spec":
        # the scripted drafter is right on two tokens in three: rollback
        # of the SSM state to each slot's last accepted token
        assert 0 < mesh["stats"]["spec_accepted"] \
            < mesh["stats"]["spec_proposed"]


def test_few_heads_variant_leaves_heads_whole(tmp_path_factory):
    """The variant's SSM state: heads whole (3 do not divide 2), the
    state's rows split over "data"; mamba2-130m's 16 heads split."""
    got = _on_mesh(tmp_path_factory)
    few = got[("few-heads", "contiguous")][0]["placements"]
    full = got[(MAMBA, "contiguous")][0]["placements"]
    h = [k for k in few if k.startswith("cache/0/") and k.endswith("h")]
    assert h, sorted(few)
    assert few[h[0]] == "(Shard(dim=0), Replicate())"
    assert full[h[0]] == "(Shard(dim=0), Shard(dim=1))"
    conv = h[0][:-1] + "conv"
    assert few[conv] == full[conv] == "(Shard(dim=0), Shard(dim=2))"


@pytest.mark.parametrize("name", [MAMBA, "few-heads"])
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_mamba2_decode_logits_on_mesh_match_one_device(name, kind,
                                                       tmp_path_factory):
    mesh, one = _on_mesh(tmp_path_factory)[(name, f"{kind} float64")]
    assert mesh["streams"] == one["streams"]
    got = np.concatenate(mesh["decode_logits"])
    want = np.concatenate(one["decode_logits"])
    assert got.shape == want.shape and np.isfinite(want).all()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("kind", ["whole", "paged", "spec"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_streams_on_mesh_equal_one_device(arch, kind, tmp_path_factory):
    """At an ample capacity, on a (2, 2) mesh: the experts on "model", the
    slots over "data"."""
    mesh, one = _on_mesh(tmp_path_factory)[(arch, kind)]
    assert mesh["streams"] == one["streams"]
    for key in parity.STAT_KEYS:
        assert mesh["stats"][key] == one["stats"][key], key
    if kind == "spec":
        assert mesh["stats"]["spec_accepted"] > 0
    # every MoE layer's call through the expert-parallel block, the
    # experts split over "model"
    assert mesh["local_calls"]["moe_block_sharded"] > 0
    assert mesh["local_calls"]["paged_attention"] > 0
    experts = [v for k, v in mesh["placements"].items()
               if k.endswith("ffn/w_gate") and v.endswith("Shard(dim=0))")]
    assert experts, mesh["placements"]


@pytest.mark.parametrize("spec", [False, True], ids=["paged", "spec"])
@pytest.mark.parametrize("gate", [False, True], ids=["gate-off", "gate-on"])
def test_vlm_with_patches_on_mesh_equals_one_device(gate, spec,
                                                    tmp_path_factory):
    key = (VLM, f"gate {gate}" + (" spec" if spec else ""))
    mesh, one = _on_mesh(tmp_path_factory)[key]
    assert mesh["streams"] == one["streams"]
    for key in parity.STAT_KEYS:
        assert mesh["stats"][key] == one["stats"][key], key
    # a request with patches is admitted whole, its patches prefilled
    cfg = harness.smoke_cfg(VLM)
    assert mesh["stats"]["prefill_chunks"] == 0
    assert mesh["stats"]["prefill_tokens"] == sum(LENS) + len(LENS) * \
        cfg.num_patches
    if spec:
        assert mesh["stats"]["spec_accepted"] > 0
    assert mesh["local_calls"]["local_attention"] > 0   # patches' prefill
    assert mesh["local_calls"]["paged_attention"] > 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
def test_host_tier_on_mesh_equals_one_device(arch, tmp_path_factory):
    mesh, one = _on_mesh(tmp_path_factory)[(arch, "host tier")]
    assert mesh["streams"] == one["streams"]
    for key in parity.POLICY_KEYS + parity.STAT_KEYS:
        assert mesh["stats"][key] == one["stats"][key], key
    assert one["stats"]["host_hits"] >= 2
    assert one["stats"]["host_spilled_pages"] >= 4
    assert one["stats"]["host_restored_pages"] >= 4


# ---------------------------------------------------------------------------
# MoE at the default capacity on a (1, 2) mesh, against the reference
# ---------------------------------------------------------------------------
MOE_MODES = [("whole", {}, {}), ("chunked", {"prefill_chunk": 3}, {}),
             ("spec", {}, {"spec_k": 3})]
_MOE_SPAWNED = {}


def _moe_runs():
    keys, runs = [], []
    for arch in MOE:
        for mode, eng, sched in MOE_MODES:
            kind = "damped" if sched else "init"
            gen = 2 * parity.GEN if sched else parity.GEN
            keys.append((arch, mode))
            runs.append(dict(
                arch=arch, params=_port_tree(arch, kind=kind),
                engine=dict(slots=parity.SLOTS, max_len=parity.MAX_LEN,
                            page_size=parity.PS, **eng),
                sched=sched, drafter=("ngram",) if sched else None,
                requests=[(p, gen, None) for p in parity.prompts(
                    harness.smoke_cfg(arch).vocab_size)]))
    return keys, runs


def _moe_on_mesh(tmp_path_factory):
    if not _MOE_SPAWNED:
        keys, runs = _moe_runs()
        got = harness.spawn("serve_runs", 2, tmp_path_factory.mktemp("moe"),
                            limit_s=240, mesh_shape=(1, 2), runs=runs)
        _MOE_SPAWNED.update(zip(keys, got[0]))
    return _MOE_SPAWNED


@pytest.mark.parametrize("mode", [m[0] for m in MOE_MODES])
@pytest.mark.parametrize("arch", MOE)
def test_moe_on_mesh_equals_reference_same_mode(arch, mode,
                                                tmp_path_factory):
    """Each mode on the (1, 2) mesh against the SAME mode of the
    reference at the default capacity (its modes may part: the capacity
    follows each call's shape)."""
    got = _moe_on_mesh(tmp_path_factory)[(arch, mode)]
    _, eng, sched = next(m for m in MOE_MODES if m[0] == mode)
    kind = "damped" if sched else "init"
    gen = 2 * parity.GEN if sched else parity.GEN
    prompt_list = parity.prompts(harness.smoke_cfg(arch).vocab_size)
    want, want_stats = parity.serve_ref_queue(
        arch, parity.params(arch, kind),
        [parity.spec(p, gen) for p in prompt_list],
        engine_kw=dict(slots=parity.SLOTS, max_len=parity.MAX_LEN,
                       page_size=parity.PS, **eng),
        sched_kw=sched, drafter=JNgram() if sched else None)
    assert got["streams"] == {k: [int(t) for t in v] for k, v in want.items()}
    for key in parity.STAT_KEYS:
        assert got["stats"][key] == want_stats[key], key
    if mode == "chunked":
        assert got["stats"]["prefill_chunks"] > 0


# ---------------------------------------------------------------------------
# Training to serving on a (2, 2) mesh
# ---------------------------------------------------------------------------
_HANDOFF = {}


def _handoff(fsdp, tmp_path_factory):
    if fsdp not in _HANDOFF:
        _HANDOFF[fsdp] = runs_of.handoff(fsdp, tmp_path_factory)
    return _HANDOFF[fsdp]


def _one_device_handoff(params):
    """``from_train_state`` from a one-device engine holding ``params``
    (the trained state gathered from the mesh), serving the same queue."""
    cfg = harness.smoke_cfg(MAMBA)
    eng = Engine.for_lm(cfg, TrainConfig(**TC), device="cpu",
                        dtype=torch.float32)
    tree = harness._tree_of(params)
    like = tfm.model_params(cfg, lambda *a: None)
    state = eng.init_state(unflatten(tree, like))
    srv, sstate = InferenceEngine.from_train_state(eng, state,
                                                   dtype=torch.float32,
                                                   **WHOLE)
    out = Scheduler(srv, sstate).run(harness._request_list(_queue(MAMBA)))
    return {k: [int(t) for t in v] for k, v in out.items()}


@pytest.mark.parametrize("fsdp", [False, True], ids=["rules", "fsdp"])
def test_from_train_state_on_mesh(fsdp, tmp_path_factory):
    got = _handoff(fsdp, tmp_path_factory)
    assert got["placements"] == got["want_placements"]
    if not fsdp:
        # the serving rules place every leaf as training did: adopted in
        # place, each float32 block the training state's own
        assert got["placements"] == got["training_placements"]
        assert all(got["shared"].values())
    else:
        # the FSDP layout (embed over "data") re-placed on the ranks
        assert got["placements"] != got["training_placements"]
        assert any("Shard" in p and "Shard(dim=0)" not in p
                   for p in got["placements"].values())
    assert got["streams"] == _one_device_handoff(got["params"])


@pytest.mark.parametrize("fsdp", [False, True], ids=["rules", "fsdp"])
def test_model_drafter_from_checkpoint_on_mesh(fsdp, tmp_path_factory):
    got = _handoff(fsdp, tmp_path_factory)
    assert got["drafter_placed"]
    assert got["drafter_err"] == 0.0
    assert got["spec_streams"] == got["streams"]
    st = got["spec_stats"]
    assert st["spec_accepted"] == st["spec_proposed"] > 0


@pytest.mark.parametrize("fsdp", [False, True], ids=["rules", "fsdp"])
def test_from_train_state_on_mesh_equals_reference(fsdp, tmp_path_factory):
    """The adopted model's streams, and those it serves with its own
    checkpoint drafting, equal the reference's serving of the trained
    params (converted to its layout) on one device."""
    got = _handoff(fsdp, tmp_path_factory)
    cfg = harness.smoke_cfg(MAMBA)
    like = tfm.model_params(cfg, lambda *a: None)
    trained = lm_params_to_jax(
        unflatten(harness._tree_of(got["params"]), like), cfg)
    run = dict(arch=MAMBA, engine=WHOLE, sched={}, requests=_queue(MAMBA))
    want, _ = runs_of.serve_ref(run, tree=trained)
    assert got["streams"] == want
    assert got["spec_streams"] == want


def test_trained_params_moved(tmp_path_factory):
    """The hand-off serves trained params, not the init's."""
    got = _handoff(False, tmp_path_factory)
    init = flatten(harness._tree_of(_port_tree(MAMBA)))
    moved = [k for k, v in got["params"].items()
             if not np.array_equal(v, init[k].numpy())]
    assert moved
