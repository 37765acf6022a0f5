"""The port's launch tooling (``launch/steps.py``, ``launch/dryrun.py``)
against the reference's, with no process group but the dry run's own.

* ``ShapeConfig``, ``INPUT_SHAPES`` and ``ASSIGNED_ARCHS`` equal to the
  reference's copies; ``matrix()`` equal to the reference's (its 32
  (arch, shape) pairs with the same skips).
* ``input_specs``: every batch input's shape and dtype, and the decode
  cache's leaves (in the reference's leaf order, a scanned block's
  stacked) equal to the reference's ``input_specs`` at every shape.
* Every config's placements at the (16, 16) and (2, 16, 16) production
  meshes, on stand-ins (the reference's ``resolve_pspec`` reads only
  ``mesh.axis_names`` and ``mesh.devices.shape``): ``param_placements``
  (and with the FSDP rule variant), ``opt_placements``,
  ``batch_placements`` at every shape and ``cache_placements`` at the
  decode shapes equal to the reference's ``param_pspecs``,
  ``opt_pspecs``, ``batch_pspecs`` and ``cache_pspecs`` leaf by leaf (a
  port layer against its stacked leaf, the repetition axis whole).
* The dry run on a fake world of 256 ranks, one step of each kind
  (train_4k, prefill_32k, decode_32k) of mamba2-130m in a subprocess
  under a deadline: its record's kind, ranks, bytes, FLOPs and
  collectives.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ASSIGNED_ARCHS, INPUT_SHAPES, ShapeConfig, TrainConfig, get_config,
)
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.state import cache_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
DRYRUN_LIMIT_S = 150


def _ref_matrix():
    """The reference's ``matrix()``: its module sets XLA_FLAGS and
    REPRO_SCAN_UNROLL on import, which are put back as they were."""
    saved = {k: os.environ.get(k) for k in ("XLA_FLAGS", "REPRO_SCAN_UNROLL")}
    try:
        from repro.launch.dryrun import matrix
        return matrix()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_shape_configs_and_arch_list_match_reference():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    for k, v in J_SHAPES.items():
        assert INPUT_SHAPES[k] == ShapeConfig(v.name, v.seq_len,
                                              v.global_batch, v.kind)
    from repro_torch.launch.dryrun import matrix
    assert matrix() == _ref_matrix()
    assert len(matrix()) == 32


def _ref_cache_leaves(cfg, cache):
    """The port's per-layer cache as the reference's leaf shapes."""
    out = []
    for leaf in cache_leaves(cfg):
        shp = tuple(getattr(cache[leaf.layers[0]], leaf.field).shape)
        out.append(((len(leaf.layers),) if leaf.stacked else ()) + shp)
    return out


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in INPUT_SHAPES:
        if INPUT_SHAPES[name].kind == "decode" and not cfg.supports_decode():
            continue
        got, want = steps.input_specs(cfg, name), jsteps.input_specs(jcfg,
                                                                       name)
        assert set(got["batch"]) == set(want["batch"])
        for k, v in want["batch"].items():
            g = got["batch"][k]
            assert g.device.type == "meta"
            assert tuple(g.shape) == v.shape, (name, k)
            assert str(g.dtype).split(".")[-1] == str(v.dtype), (name, k)
        if "cache" in want:
            jleaves = jax.tree.leaves(want["cache"])
            assert _ref_cache_leaves(cfg, got["cache"]) == [
                tuple(x.shape) for x in jleaves]
            for leaf, jl in zip(cache_leaves(cfg), jleaves):
                t = getattr(got["cache"][leaf.layers[0]], leaf.field)
                assert str(t.dtype).split(".")[-1] == str(jl.dtype), leaf
            assert tuple(got["position"].shape) == ()


def _meshes(shape):
    names = MESHES[shape]
    return (shd.MeshShape(names, shape),
            SimpleNamespace(axis_names=names,
                            devices=np.empty(shape, dtype=object)))


def _spec_placements(spec, ndim, mesh):
    return shd.placements_of(tuple(spec) + (None,) * (ndim - len(spec)),
                             mesh)


def _unstack(pl):
    """A stacked leaf's placements as a port layer's (dims one less)."""
    assert all(not (isinstance(p, shd.Shard) and p.dim == 0) for p in pl)
    return tuple(shd.Shard(p.dim - 1) if isinstance(p, shd.Shard) else p
                 for p in pl)


def _ref_param_placements(cfg, jcfg, mesh, jmesh, jrules):
    """The reference's ``param_pspecs`` as the port's flat per-layer
    placements."""
    jspecs, jshapes = jsteps.param_pspecs(jcfg, jmesh, jrules)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        flat["/".join(keys)] = spec
    shapes = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path): s.shape
              for path, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    prefix, pat, n_rep, suffix = tfm.stack_plan(cfg)
    out = {}
    for key in steps.param_shapes(cfg):
        parts = key.split("/")
        if parts[0] != "layers":
            out[key] = _spec_placements(flat[key], len(shapes[key]), mesh)
            continue
        i, rest = int(parts[1]), "/".join(parts[2:])
        if i < len(prefix):
            jk, stacked = f"prefix/{i}/{rest}", False
        elif i < len(prefix) + n_rep * len(pat):
            jk, stacked = f"blocks/{(i - len(prefix)) % len(pat)}/{rest}", True
        else:
            jk = f"suffix/{i - len(prefix) - n_rep * len(pat)}/{rest}"
            stacked = False
        pl = _spec_placements(flat[jk], len(shapes[jk]), mesh)
        out[key] = _unstack(pl) if stacked else pl
    return out


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_placements_at_production_meshes_match_reference(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mesh, jmesh = _meshes(shape)
    for fsdp in (False, True):
        rules = shd.make_rules(cfg, mesh=mesh, fsdp=fsdp)
        jrules = jshd.make_rules(jcfg, mesh=jmesh, fsdp=fsdp)
        got = steps.param_placements(cfg, mesh, rules)
        want = _ref_param_placements(cfg, jcfg, mesh, jmesh, jrules)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (k, fsdp)
        # the optimizer state: each moment as its param, the step whole
        opt = steps.opt_placements(got, TrainConfig(), mesh)
        jopt = jsteps.opt_pspecs(
            jsteps.param_pspecs(jcfg, jmesh, jrules)[0], JTrainConfig())
        assert opt.mu == opt.nu == got
        assert tuple(jopt.step) == () and opt.step == (shd.Replicate(),) * len(
            shape)
    rules = shd.make_rules(cfg, mesh=mesh)
    jrules = jshd.make_rules(jcfg, mesh=jmesh)
    for name, sc in INPUT_SHAPES.items():
        if sc.kind == "decode" and not cfg.supports_decode():
            continue
        specs = steps.input_specs(cfg, name)
        jspecs = jsteps.input_specs(jcfg, name)
        got = steps.batch_placements(cfg, sc, mesh, rules, specs["batch"])
        want = jsteps.batch_pspecs(jcfg, J_SHAPES[name], jmesh, jrules,
                                   jspecs["batch"])
        for k, v in want.items():
            assert got[k] == _spec_placements(v, len(specs["batch"][k].shape),
                                              mesh), (name, k)
        if sc.kind != "decode":
            continue
        got = steps.cache_placements(cfg, specs["cache"], mesh, rules)
        want = jax.tree.leaves(
            jsteps.cache_pspecs(jcfg, jspecs["cache"], jmesh, jrules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        jshapes = [x.shape for x in jax.tree.leaves(jspecs["cache"])]
        for leaf, w, jshape in zip(cache_leaves(cfg), want, jshapes):
            pl = _spec_placements(w, len(jshape), mesh)
            if leaf.stacked:
                pl = _unstack(pl)
            for i in leaf.layers:
                assert getattr(got[i], leaf.field) == pl, (name, leaf)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_dryrun_on_a_fake_world(shape_name, tmp_path):
    """mamba2-130m's step of each kind on 256 fake ranks, in a subprocess
    under a deadline: the record names the step, the (16, 16) mesh, the
    rank's bytes, a positive FLOP count and its collectives."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "mamba2-130m", "--shape", shape_name,
           "--out", str(tmp_path)]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=DRYRUN_LIMIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / f"mamba2-130m__{shape_name}__pod.json")
                     .read_text())
    kind = INPUT_SHAPES[shape_name].kind
    assert rec["step_kind"] == kind
    assert rec["ranks"] == 256 and rec["mesh_shape"] == [16, 16]
    assert rec["rank0_flops"] > 0
    by = rec["rank0_bytes"]
    assert by["params"] > 0 and by["batch"] > 0
    assert ("opt" in by) == (kind == "train")
    assert ("cache" in by) == (kind == "decode")
    # the training step reduces its gradients over the data axis
    if kind == "train":
        assert rec["collectives"]["total_count"] > 0
    assert rec["collectives"]["total_send_bytes"] >= 0
    assert "not device times" in rec["note"]
