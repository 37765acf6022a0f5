"""The port's rule table and resolver against the reference's, with no
process group: stand-in meshes of shapes (1,1), (2,2), (4,2), (16,16) and
(2,16,16) (``MeshShape`` for the port, an object with the reference's
``axis_names`` and ``devices.shape`` for it).

* ``make_rules`` equal entry for entry, for every registered config, with
  ``fsdp`` and ``sequence_parallel`` on and off;
* every logical-axes tree of the port (``core/*::param_specs``,
  ``domst.stacked_param_specs``, ``models/*::param_specs``,
  ``transformer.param_specs`` and the LM engine's ``flat_param_specs``)
  against the reference's ``param_specs(cfg)``: the reference's stacked
  repetitions unstacked into the port's layers, and the few leaves the
  port keeps in another layout mapped onto it (the LSTM's packed 4H axis
  ``a`` becomes the gate-split (None, ``a``); Pix-Con's ``w2`` loses its
  unit axis);
* each leaf resolved by the port equal to the reference's
  ``resolve_pspec`` of the same leaf (on the mapped axes and the port's
  shape where the layout differs), for params (which the optimizer
  moments share) under both rule variants, and for every batch input.
The placements hold the same assignment: ``Shard(d)`` on a mesh dim
exactly where dim d takes that mesh axis (and it has more than one rank).

Two cases spawn gloo ranks (``torch_dist_harness.py``): ``distribute``'s
local block owns its storage (a first-dim block of a value already on
the device in its dtype is copied, not kept as a view of the whole leaf),
and after ``init_state`` of a stacked Dom-ST engine and an FSDP mamba2
engine at (2, 2) each rank holds, leaf by leaf, its shard's share of the
params and both moments.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import torch_dist_harness as harness  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES  # noqa: E402
from repro.core import domst as ref_domst  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch.steps import batch_axes as ref_batch_axes  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.convert import to_port_layout  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train.engine import lm_batch_axes  # noqa: E402

MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (4, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
VARIANTS = [dict(fsdp=f, sequence_parallel=s)
            for f in (False, True) for s in (False, True)]
DOMST = ("domst", "domst-singlehead", "domst-singlehead-p")
LMS = tuple(n for n in list_configs() if n not in DOMST)


def _meshes(shape):
    names = MESHES[shape]
    return (shd.MeshShape(names, shape),
            SimpleNamespace(axis_names=names,
                            devices=np.empty(shape, dtype=object)))


def _is_leaf(v):
    """An axes tuple or a shape tuple."""
    return isinstance(v, tuple) and all(
        isinstance(e, (str, int, type(None))) for e in v)


def _ref_flat(tree, key=""):
    """A nested tree of axes (or shape) tuples -> {path: tuple}."""
    out = {}
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else tree.items())
    for k, v in items:
        path = f"{key}/{k}" if key else str(k)
        if _is_leaf(v):
            out[path] = v
        else:
            out.update(_ref_flat(v, path))
    return out


def _check_leaf(port_axes, port_shape, ref_axes, ref_shape, mesh, rmesh,
                rules, rrules):
    got = shd.resolve_axes(port_axes, port_shape, mesh, rules)
    want = tuple(ref_shd.resolve_pspec(ref_axes, ref_shape, rmesh, rrules))
    want = want + (None,) * (len(ref_axes) - len(want))
    assert got == want, (port_axes, port_shape, ref_axes)
    pl = shd.placements_of(got, mesh)
    for name, size, p in zip(mesh.axis_names, mesh.shape, pl):
        dims = [d for d, a in enumerate(got)
                if a == name or (isinstance(a, tuple) and name in a)]
        assert p == (Shard(dims[0]) if dims and size > 1 else Replicate())
    return got


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("name", list_configs())
def test_make_rules_match_reference(name, shape):
    mesh, rmesh = _meshes(shape)
    for kw in VARIANTS:
        got = shd.make_rules(get_config(name), mesh=mesh, **kw)
        want = ref_shd.make_rules(ref_config(name), mesh=rmesh, **kw)
        assert got == want, (name, shape, kw)
        assert shd.cache_needs_seq_shard(get_config(name), mesh) == \
            ref_shd.cache_needs_seq_shard(ref_config(name), rmesh)
    assert shd.make_rules() == ref_shd.make_rules()


def test_resolver_rules_of_the_reference():
    """An indivisible dim replicates; a mesh axis is used once, first dim
    first; a tuple assignment shards one dim over both mesh dims in order."""
    mesh, rmesh = _meshes((2, 16, 16))
    rules = shd.make_rules(mesh=mesh, fsdp=True)
    cases = [(("batch", "embed"), (64, 64)), (("batch", None), (3, 8)),
             (("heads", "ffn"), (32, 32)), (("heads", "ffn"), (24, 32)),
             (("vocab", "embed"), (256128, 2304))]
    for axes, shape in cases:
        _check_leaf(axes, shape, axes, shape, mesh, rmesh, rules,
                    ref_shd.make_rules(mesh=rmesh, fsdp=True))
    assert shd.resolve(("batch", "embed"), (64, 64), mesh, rules) == \
        (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):
        shd.resolve_axes(("batch",), (4, 4), mesh, rules)


def test_logical_sharding_is_seen_from_other_threads():
    """The context is process-wide: autograd runs a CUDA backward, and the
    forward remat recomputes in it, on its own device threads, which must
    place activations as the forward did."""
    import threading
    mesh, _ = _meshes((2, 2))
    rules = shd.make_rules(mesh=mesh)
    seen = []
    with shd.logical_sharding(mesh, rules):
        t = threading.Thread(target=lambda: seen.append(shd.current()))
        t.start()
        t.join()
        with shd.suspend_logical_sharding():
            assert shd.current() is None
        assert shd.current() == (mesh, rules)
    assert seen == [(mesh, rules)] and shd.current() is None


# ---------------------------------------------------------------------------
# Dom-ST trees
# ---------------------------------------------------------------------------
def _port_layout_axes(key, ax):
    """A reference leaf's axes in the port's layout."""
    if key.endswith("pixcon/w2"):
        assert ax[-1] is None
        return ax[:-1]
    if "/lstm" in key or key.startswith("lstm"):
        return ax[:-1] + (None, ax[-1])
    return ax


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("name", DOMST)
def test_domst_trees_resolve_as_reference(name, shape):
    cfg, rcfg = get_config(name), ref_config(name)
    mesh, rmesh = _meshes(shape)
    ref = _ref_flat(ref_domst.param_specs(rcfg))
    ref_st = _ref_flat(ref_domst.stacked_param_specs(rcfg))
    port, port_st = domst.param_specs(cfg), domst.stacked_param_specs(cfg)
    assert set(port) == set(ref) == set(port_st) == set(domst.param_shapes(cfg))
    for key in ref:
        assert port[key] == _port_layout_axes(key, ref[key]), key
        assert port_st[key] == ("batch",) + port[key]
        assert ref_st[key] == ("batch",) + ref[key]
    for kw in VARIANTS:
        rules = shd.make_rules(cfg, mesh=mesh, **kw)
        rrules = ref_shd.make_rules(rcfg, mesh=rmesh, **kw)
        for R in (1, 3, 4, 23, 32):
            for key, (lshape, _) in domst.param_shapes(cfg).items():
                full = (R,) + tuple(lshape)
                pshape = to_port_layout(key, np.empty(full)).shape
                mapped = full != pshape
                _check_leaf(port_st[key], pshape,
                            port_st[key] if mapped else ref_st[key],
                            pshape if mapped else full,
                            mesh, rmesh, rules, rrules)
        # batch inputs, stacked (watershed axis first) and single (R = 1)
        for stacked in (True, False):
            axes = domst.batch_specs(stacked)
            for k, ax in ref_domst.BATCH_AXES.items():
                want = ((("batch",) + tuple(None if a == "batch" else a
                                            for a in ax))
                        if stacked else (None,) + ax)
                assert axes[k] == want
                shp = {"precip": (4, 32, 30, 64), "target_day": (4, 32, 64),
                       "dist": (4, 32, 64), "discharge": (4, 32)}[k]
                if not stacked:
                    shp = (1,) + shp[1:]
                _check_leaf(axes[k], shp, want, shp, mesh, rmesh, rules,
                            rrules)


# ---------------------------------------------------------------------------
# LM trees
# ---------------------------------------------------------------------------
def _ref_layers(rcfg, specs, shapes):
    """The reference's (axes, shape) of every layer in the port's order."""
    prefix, pat, n_rep, suffix = ref_tfm.stack_plan(rcfg)
    out = []
    for i in range(len(prefix)):
        out.append((_ref_flat(specs["prefix"][i]),
                    _ref_flat(shapes["prefix"][i])))
    for _ in range(n_rep):
        for i in range(len(pat)):
            out.append((_ref_flat(specs["blocks"][str(i)]),
                        _ref_flat(shapes["blocks"][str(i)])))
    for i in range(len(suffix)):
        out.append((_ref_flat(specs["suffix"][i]),
                    _ref_flat(shapes["suffix"][i])))
    return out


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("name", LMS)
def test_lm_trees_resolve_as_reference(name, shape):
    cfg, rcfg = get_config(name), ref_config(name)
    mesh, rmesh = _meshes(shape)
    rspecs = ref_tfm.param_specs(rcfg)
    rshapes = jax.eval_shape(lambda: ref_tfm.init(rcfg, jax.random.key(0)))
    rshapes = jax.tree.map(lambda a: tuple(a.shape), rshapes)
    pspecs = tfm.param_specs(cfg)
    pshapes = tfm.model_params(cfg, lambda shp, *a: tuple(shp))
    flat_axes = tfm.flat_param_specs(cfg)
    layers = _ref_layers(rcfg, rspecs, rshapes)
    assert len(layers) == len(pspecs["layers"]) == len(pshapes["layers"])
    top = [g for g in ("embed", "final_norm", "gate", "frontend")
           if g in rspecs]
    assert sorted(top) == sorted(k for k in pspecs if k != "layers")
    batch = ref_batch_axes(rcfg, INPUT_SHAPES["train_4k"])
    for kw in VARIANTS:
        rules = shd.make_rules(cfg, mesh=mesh, **kw)
        rrules = ref_shd.make_rules(rcfg, mesh=rmesh, **kw)
        leaves = []
        for g in top:
            ra, rs = _ref_flat(rspecs[g]), _ref_flat(rshapes[g])
            pa = _ref_flat(pspecs[g])
            assert set(pa) == set(ra), g
            leaves += [(f"{g}/{k}", pa[k], rs[k], ra[k], rs[k]) for k in ra]
        for i, (ra, rs) in enumerate(layers):
            pa = _ref_flat(pspecs["layers"][i])
            ps = _ref_flat(pshapes["layers"][i])
            assert set(pa) == set(ra) == set(ps), i
            for k in ra:
                # the reference's blocks carry the repetition axis first
                rax, rsh = ra[k], rs[k]
                if len(rax) == len(ps[k]) + 1:
                    assert rax[0] is None
                    rax, rsh = rax[1:], rsh[1:]
                leaves.append((f"layers/{i}/{k}", pa[k], ps[k], rax, rsh))
        assert {k for k, *_ in leaves} == set(flat_axes)
        for key, pax, pshp, rax, rsh in leaves:
            assert pax == rax, key
            got = _check_leaf(pax, pshp, rax, rsh, mesh, rmesh, rules, rrules)
            # the engine's flat tree: a leading replica axis of 1
            assert flat_axes[key] == (None,) + pax
            assert shd.resolve_axes(flat_axes[key], (1,) + tuple(pshp), mesh,
                                    rules) == (None,) + got
        # batch inputs (the engine's replica axis of 1 in front)
        port_batch = lm_batch_axes(cfg)
        for k, ax in batch.items():
            assert port_batch[k] == (None,) + ax, k
            shp = (256, 4096) + ((cfg.frontend_dim,) if len(ax) == 3 else ())
            got = _check_leaf(ax, shp, ax, shp, mesh, rmesh, rules, rrules)
            assert shd.resolve_axes(port_batch[k], (1,) + shp, mesh,
                                    rules) == (None,) + got


# ---------------------------------------------------------------------------
# Placed values own their storage (gloo ranks)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_distribute_blocks_own_their_storage(mesh_shape, tmp_path):
    world = mesh_shape[0] * mesh_shape[1]
    for got in harness.spawn("distribute_storage", world, tmp_path,
                             mesh_shape=mesh_shape):
        for name, (storage, own, equal) in got.items():
            assert equal, name
            assert storage == own, (name, storage, own)


def test_init_state_holds_each_ranks_share(tmp_path):
    got = harness.spawn("init_state_bytes", 4, tmp_path, mesh_shape=(2, 2))
    for rank in got:
        for tree, leaves in rank.items():
            held = sum(h for h, _, _ in leaves.values())
            assert held == sum(s for _, s, _ in leaves.values()), tree
            for k, (h, share, _) in leaves.items():
                assert h == share, (tree, k, h, share)
            # both mesh axes split some leaf of every tree
            assert {w for _, _, w in leaves.values()} >= {2, 4}, tree
