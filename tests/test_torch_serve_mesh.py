"""Serving on a mesh and the contiguous cache, against the reference.

* The contiguous ``transformer.decode_step`` (``init_cache``,
  ``apply_layer_decode``, ``attention.decode_attention``) against the
  reference's, float32 at smoke size, for qwen2-1.5b, gemma2-2b (prompts
  past its window: a local layer's ring is the window long),
  recurrentgemma-2b and mamba2-130m: prompts prefilled one slot each and
  scattered into a two-slot cache (``scatter_slot``), then decode steps
  at a scalar position (both slots at one index) and at a vector of
  per-slot positions (ragged prompts): the logits within 1e-5 of their
  scale, every cache leaf (in the reference's leaf order,
  ``serve.state.cache_leaves``) within 1e-5 of its scale, positions
  equal.
* The engine's contiguous layout (``paged=False``) serves the same
  greedy streams as the paged one, and refuses what the reference's
  refuses.
* On a (4, 2) stand-in mesh (the placements need no ranks), the state's
  placements (``state_shardings``) equal the reference's rule tables
  (``resolve_pspec``) leaf by leaf, in both ``cache_needs_seq_shard``
  branches, for the contiguous and the paged layout: the counterparts of
  the reference's ``test_inference_state_shardings_match_rule_tables``
  and ``test_paged_pool_shardings_match_rule_tables``.
* On gloo ranks (``torch_dist_harness.py``), a (2, 2) and a (4, 2) mesh:
  the state's DTensor placements equal the rule tables', and greedy
  streams on the mesh equal one device's: paged with chunks and
  contiguous for qwen2-1.5b, gemma2-2b and recurrentgemma-2b (the
  reference's ``test_paged_vs_contiguous_parity_on_mesh``), speculative
  streams (a scripted drafter, right on two tokens in three) equal to the
  mesh's ``spec_k=0`` streams (``test_spec_parity_on_mesh``), a sampled
  stream equal to one device's, the model drafter on the mesh, and the
  prefix cache with copy-on-write and preemption (the page hooks' rows
  gathered and scattered on local blocks) equal to one device's.
  One spawn a mesh shape serves every case (a module fixture); the
  one-device side runs in the test's own process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_dist_harness as harness  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.distributed.sharding import \
    cache_needs_seq_shard as j_cache_needs_seq_shard  # noqa: E402
from repro.distributed.sharding import make_rules as j_make_rules  # noqa: E402
from repro.distributed.sharding import resolve_pspec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import state as jstate  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import InferenceEngine, Request, Scheduler  # noqa: E402
from repro_torch.serve.state import cache_leaves, scatter_slot  # noqa: E402

torch.set_num_threads(1)
REL = 1e-5
ARCHS = ["qwen2-1.5b", "gemma2-2b", "recurrentgemma-2b", "mamba2-130m"]


def _close(got, want, rel=REL, what=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


def _ref_leaves_of_port(cfg, cache):
    """The port's per-layer cache as the reference's leaves, in order."""
    out = []
    for leaf in cache_leaves(cfg):
        rows = [getattr(cache[i], leaf.field).numpy() for i in leaf.layers]
        out.append(np.stack(rows) if leaf.stacked else rows[0])
    return out


def _close_cache(cfg, cache, jcache):
    want = jax.tree.leaves(jcache)
    got = _ref_leaves_of_port(cfg, cache)
    assert len(got) == len(want)
    for leaf, g, w in zip(cache_leaves(cfg), got, want):
        assert g.shape == w.shape, (leaf, g.shape, w.shape)
        if leaf.field == "pos":
            np.testing.assert_array_equal(g, np.asarray(w))
        else:
            _close(g, w, what=leaf)


def _jparams(jcfg, seed=0):
    """The reference's init with the attention projections redrawn at
    unit variance over their inputs (the init law's 1/sqrt(Hq) for ``wq``
    turns a float32 last-bit difference into a 1e-4 one at smoke widths,
    ``test_torch_lm.py``)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(seed)))

    def redraw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("wq", "wk", "wv"):
            return (rng.normal(size=a.shape)
                    / np.sqrt(a.shape[-3])).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


# ---------------------------------------------------------------------------
# The contiguous cache, one device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_decode_step_matches_reference(arch, vector):
    jcfg = j_smoke_variant(j_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    tree = _jparams(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    params = tfm.cast_params(params_from_jax(tree), torch.float32)
    max_len, slots = 32, 2
    lens = [20, 13] if vector else [20, 20]       # past gemma2's window of 16
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
               for n in lens]
    jc = jtfm.init_cache(jcfg, slots, max_len, dtype=jnp.float32)
    tc = tfm.init_cache(cfg, slots, max_len, dtype=torch.float32)
    axes = jtfm.cache_axes(jcfg)
    for slot, p in enumerate(prompts):
        jl, one = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(p)}, max_len,
                               dtype=jnp.float32)
        tl, tone = tfm.prefill(params, cfg, {"tokens": torch.tensor(p)},
                               max_len, dtype=torch.float32)
        _close(tl, jl, what="prefill")
        jc = jstate.scatter_slot(axes, jc, one, slot)
        scatter_slot(tc, tone, slot)
    _close_cache(cfg, tc, jc)
    pos = np.array(lens, np.int32)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (slots, 1)).astype(np.int32)
        jpos = jnp.asarray(pos) if vector else jnp.asarray(int(pos[0]))
        tpos = torch.tensor(pos) if vector else torch.tensor(int(pos[0]))
        jl, jc = jtfm.decode_step(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                                  jpos, dtype=jnp.float32)
        tl, tc = tfm.decode_step(params, cfg, {"tokens": torch.tensor(toks)},
                                 tc, tpos, dtype=torch.float32)
        _close(tl, jl, what=("decode", step))
        _close_cache(cfg, tc, jc)
        pos = pos + 1


def test_cache_axes_match_reference():
    """``cache_axes``/``paged_cache_axes`` per layer, as the reference's
    leaves (a scanned block's with its leading repetition axis)."""
    for arch in ARCHS:
        jcfg = j_smoke_variant(j_get_config(arch))
        cfg = smoke_variant(get_config(arch))
        for paged in (False, True):
            want = jax.tree.leaves((jtfm.paged_cache_axes if paged
                                    else jtfm.cache_axes)(jcfg),
                                   is_leaf=shd.is_axes)
            port = (tfm.paged_cache_axes if paged else tfm.cache_axes)(cfg)
            got = [((None,) if leaf.stacked else ())
                   + getattr(port[leaf.layers[0]], leaf.field)
                   for leaf in cache_leaves(cfg)]
            assert got == want, (arch, paged)


def _requests(cfg, lens, gen=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=gen)
            for i, n in enumerate(lens)]


def _serve_one_device(arch, tree, lens, **kw):
    cfg = smoke_variant(get_config(arch))
    sched_kw = {k: kw.pop(k) for k in ("spec_k", "drafter") if k in kw}
    eng = InferenceEngine(cfg, slots=4, max_len=32, dtype=torch.float32,
                          device="cpu", **kw)
    sched = Scheduler(eng, eng.init_state(params_from_jax(tree)), **sched_kw)
    out = sched.run(_requests(cfg, lens))
    return {k: list(map(int, v)) for k, v in out.items()}, sched


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b",
                                  "recurrentgemma-2b"])
def test_contiguous_engine_streams_equal_paged(arch):
    jcfg = j_smoke_variant(j_get_config(arch))
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(0)))
    lens = [20, 5, 18, 6]
    want, _ = _serve_one_device(arch, tree, lens, page_size=4,
                                prefill_chunk=3)
    got, sched = _serve_one_device(arch, tree, lens, paged=False)
    assert got == want
    assert sched.state.page_table is None


def test_contiguous_engine_refuses_paged_operations():
    cfg = smoke_variant(get_config("qwen2-1.5b"))
    with pytest.raises(ValueError, match="prefill_chunk"):
        InferenceEngine(cfg, paged=False, prefill_chunk=4, device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        InferenceEngine(cfg, page_size=0, device="cpu")
    eng = InferenceEngine(cfg, paged=False, slots=2, max_len=16,
                          dtype=torch.float32, device="cpu")
    assert eng.page_size is None and eng.num_pages is None
    assert eng.has_recurrent_state
    state = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="active"):
        eng.decode(state, active=np.ones(2, bool))
    with pytest.raises(ValueError, match="paged=True"):
        eng.verify(state, np.zeros((2, 2), np.int32), [2, 2], [True, True])
    with pytest.raises(ValueError, match="paged"):
        eng.insert_chunk(state, {"tokens": np.zeros((1, 3), np.int32)}, 0, 0)
    with pytest.raises(ValueError, match="paged"):
        eng.assign_pages(state, 0, [0])
    with pytest.raises(ValueError, match="spec_k|paged"):
        Scheduler(eng, state, spec_k=2)


# ---------------------------------------------------------------------------
# Placements on a stand-in mesh, against the reference's rule tables
# ---------------------------------------------------------------------------
class _RefMesh:
    """What the reference's ``resolve_pspec`` and ``make_rules`` read of
    a mesh: ``axis_names`` and ``devices.shape``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _want_placements(axes, shape, jmesh, jrules, mesh):
    spec = resolve_pspec(axes, shape, jmesh, jrules)
    return shd.placements_of(tuple(spec) + (None,) * (len(shape) - len(spec)),
                             mesh)


def _ref_state_axes_and_shapes(jcfg, eng, paged):
    """The reference's state: its axes tree and leaf shapes (eval_shape)."""
    if paged:
        axes = jstate.paged_inference_state_axes(jcfg)
        st = jax.eval_shape(lambda: jstate.new_paged_inference_state(
            jtfm.init(jcfg, jax.random.key(0)), jcfg, slots=eng.slots,
            num_pages=eng.num_pages, pages_per_slot=eng.pages_per_slot,
            page_size=eng.page_size, dtype=jnp.float32))
    else:
        axes = jstate.inference_state_axes(jcfg)
        st = jax.eval_shape(lambda: jstate.new_inference_state(
            jtfm.init(jcfg, jax.random.key(0)), jcfg, slots=eng.slots,
            max_len=eng.max_len, dtype=jnp.float32))
    return axes, st


def _port_placements_as_ref_leaves(cfg, pl):
    """``state_shardings``' cache placements in the reference's leaf order
    (a scanned block's leaf: its layers must agree; the repetition axis is
    whole, a Shard(d) of the port's leaf is Shard(d + 1) there)."""
    out = []
    for leaf in cache_leaves(cfg):
        got = {getattr(pl.cache[i], leaf.field) for i in leaf.layers}
        assert len(got) == 1, leaf
        p = got.pop()
        if leaf.stacked:
            p = tuple(shd.Shard(x.dim + 1) if isinstance(x, shd.Shard) else x
                      for x in p)
        out.append(p)
    return out


def _check_state_placements(arch, mesh_shape, ffn_mode, paged):
    jcfg = j_smoke_variant(j_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    if ffn_mode:
        jcfg, cfg = jcfg.replace(tp_mode="ffn"), cfg.replace(tp_mode="ffn")
    names = ("data", "model")
    jmesh = _RefMesh(mesh_shape, names)
    mesh = shd.MeshShape(names, mesh_shape)
    jrules = j_make_rules(jcfg, mesh=jmesh)
    assert shd.cache_needs_seq_shard(cfg, mesh) == \
        j_cache_needs_seq_shard(jcfg, jmesh)
    eng = InferenceEngine(cfg, mesh=mesh, slots=4, max_len=16,
                          dtype=torch.float32, paged=paged, page_size=4,
                          num_pages=8, device="cpu")
    assert eng.rules == jrules
    pl = eng.state_shardings(_plain_state(eng, cfg))
    axes, st = _ref_state_axes_and_shapes(jcfg, eng, paged)
    # params, leaf by leaf (the port's per-layer tree against the
    # reference's stacked one: each layer takes its stacked leaf's
    # placement, the repetition axis whole)
    got_params = _flat(pl.params)
    want = {}
    jflat = jax.tree_util.tree_flatten_with_path(
        axes.params, is_leaf=shd.is_axes)[0]
    jshapes = dict((jax.tree_util.keystr(p), s.shape) for p, s in
                   jax.tree_util.tree_flatten_with_path(st.params)[0])
    for path, ax in jflat:
        want[jax.tree_util.keystr(path)] = _want_placements(
            ax, jshapes[jax.tree_util.keystr(path)], jmesh, jrules, mesh)
    _match_params(cfg, got_params, want)
    # the cache, in the reference's leaf order
    jcache_axes = jax.tree.leaves(axes.cache, is_leaf=shd.is_axes)
    jcache_shapes = [s.shape for s in jax.tree.leaves(st.cache)]
    got_cache = _port_placements_as_ref_leaves(cfg, pl)
    for a, s_, g in zip(jcache_axes, jcache_shapes, got_cache):
        assert g == _want_placements(a, s_, jmesh, jrules, mesh), (a, s_, g)
    # the per-slot rows and the page table
    for name in ("positions", "last_tok", "sample_temp", "sample_key",
                 "tok_presence") + (("page_table",) if paged else ()):
        want_pl = _want_placements(getattr(axes, name),
                                   getattr(st, name).shape, jmesh, jrules,
                                   mesh)
        assert getattr(pl, name) == want_pl, name
        assert want_pl[0] == shd.Shard(0)              # on "data"
    if not paged:
        assert pl.page_table is None
    return eng, pl


def _plain_state(eng, cfg):
    """The engine's state before placement (meta tensors)."""
    from repro_torch.serve.state import (
        new_inference_state, new_paged_inference_state,
    )
    params = tfm.model_params(
        cfg, lambda shape, *a: torch.empty(shape, device="meta"))
    if eng.paged:
        return new_paged_inference_state(
            params, cfg, slots=eng.slots, num_pages=eng.num_pages,
            pages_per_slot=eng.pages_per_slot, page_size=eng.page_size,
            dtype=torch.float32, device="meta", shards=eng._page_shards())
    return new_inference_state(params, cfg, slots=eng.slots,
                               max_len=eng.max_len, dtype=torch.float32,
                               device="meta")


def _flat(tree, key=""):
    """A tree of placements keyed by '/'-joined paths."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{key}/{k}" if key else k).items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{key}/{i}").items()}
    return {key: tree}


def _match_params(cfg, got, want):
    """Port leaf ``layers/<i>/<path>`` against the reference's leaf of the
    layer's place in the stack (prefix, blocks rep, suffix)."""
    prefix, pat, n_rep, suffix = tfm.stack_plan(cfg)
    for key, pl in got.items():
        parts = key.split("/")
        if parts[0] != "layers":
            jkey = "".join(f"['{p}']" for p in parts)
            assert pl == want[jkey], key
            continue
        i, rest = int(parts[1]), parts[2:]
        if i < len(prefix):
            head, stacked = f"['prefix'][{i}]", False
        elif i < len(prefix) + n_rep * len(pat):
            head = f"['blocks']['{(i - len(prefix)) % len(pat)}']"
            stacked = True
        else:
            head = f"['suffix'][{i - len(prefix) - n_rep * len(pat)}]"
            stacked = False
        w = want[head + "".join(f"['{p}']" for p in rest)]
        if stacked:
            w = tuple(shd.Shard(x.dim - 1) if isinstance(x, shd.Shard)
                      else x for x in w)
        assert pl == w, key


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("ffn_mode", [False, True], ids=["heads", "ffn"])
def test_state_placements_match_rule_tables(ffn_mode, paged):
    """(4, 2): olmo-1b's kv heads split over "model" (cache_seq whole),
    its ffn-mode variant the cache's sequence axis (the ring's L, a
    page's offsets) on "model" instead; slots, pages and the page table
    on "data"."""
    assert shd.cache_needs_seq_shard(
        smoke_variant(get_config("olmo-1b")).replace(
            tp_mode="ffn" if ffn_mode else "heads"),
        shd.MeshShape(("data", "model"), (4, 2))) == ffn_mode
    eng, pl = _check_state_placements("olmo-1b", (4, 2), ffn_mode, paged)
    first = next(c for c in pl.cache if hasattr(c, "k"))
    assert first.k[0] == shd.Shard(0)                    # slots / pages
    assert first.k[1] == (shd.Shard(1) if ffn_mode else shd.Shard(2))
    if paged:
        assert eng._page_shards() == 4


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b",
                                  "mamba2-130m", "gemma2-2b"])
def test_state_placements_of_served_archs(arch):
    for paged in (False, True):
        _check_state_placements(arch, (4, 2), False, paged)


# ---------------------------------------------------------------------------
# Serving on gloo meshes, against one device
# ---------------------------------------------------------------------------
MESH_ARCHS = ["qwen2-1.5b", "gemma2-2b", "recurrentgemma-2b"]
MESH_LENS = [8, 5, 7, 6]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95, seed=3)
KINDS = ("contiguous", "paged", "spec", "sampled", "model")


def _port_tree(arch):
    """The reference's init of the smoke config in the port's layout, as
    numpy (what every rank and the one-device run take)."""
    jcfg = j_smoke_variant(j_get_config(arch))
    tree = params_from_jax(jax.tree.map(
        np.asarray, jtfm.init(jcfg, jax.random.key(0))))

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, list):
            return [host(v) for v in t]
        return t.numpy()
    return host(tree)


def _queue(arch, sampled=False):
    cfg = smoke_variant(get_config(arch))
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 4,
             dict(SAMPLED, seed=3 + i) if sampled else None)
            for i, n in enumerate(MESH_LENS)]


PAGED = dict(slots=4, max_len=16, page_size=4, prefill_chunk=3)
# the prefix cache with copy-on-write and preemption on a pool of 8 pages
# (a request takes up to 4): shared 8-token prefixes
POLICY_ENGINE = dict(slots=4, max_len=16, page_size=4, num_pages=8,
                     prefill_chunk=4)
POLICY_SCHED = dict(prefix_cache=True, preempt=True)


def _policy_queue():
    cfg = smoke_variant(get_config("qwen2-1.5b"))
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    return [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)
                             .astype(np.int32)]), 4, None)
            for n in (4, 3, 4, 2)]
CONTIG = dict(slots=4, max_len=16, paged=False)


def _runs():
    """(kind, arch) of each run, and the runs: per arch contiguous, paged
    with chunks, spec (scripted drafter, truth: the contiguous run), and
    contiguous and paged in float64;
    qwen2-1.5b also sampled, and with the model drafter."""
    keys, runs = [], []
    for arch in MESH_ARCHS:
        tree = _port_tree(arch)
        first = len(runs)
        for kind, eng, sched, drafter in (
                ("contiguous", CONTIG, {}, None),
                ("paged", PAGED, {}, None),
                ("spec", dict(PAGED, prefill_chunk=0), {"spec_k": 3},
                 ("script", 2, first))):
            keys.append((kind, arch))
            runs.append(dict(arch=arch, params=tree, engine=eng, sched=sched,
                             requests=_queue(arch), drafter=drafter))
        for kind, eng in (("contiguous", CONTIG), ("paged", PAGED)):
            keys.append((f"{kind} float64", arch))
            runs.append(dict(arch=arch, params=tree, engine=eng, sched={},
                             requests=_queue(arch), drafter=None,
                             dtype="float64"))
    tree = _port_tree("qwen2-1.5b")
    keys += [("sampled", "qwen2-1.5b"), ("model", "qwen2-1.5b"),
             ("policies", "qwen2-1.5b")]
    runs += [dict(arch="qwen2-1.5b", params=tree, engine=PAGED, sched={},
                  requests=_queue("qwen2-1.5b", sampled=True), drafter=None),
             dict(arch="qwen2-1.5b", params=tree,
                  engine=dict(PAGED, prefill_chunk=0), sched={"spec_k": 3},
                  requests=_queue("qwen2-1.5b"), drafter=("model",)),
             dict(arch="qwen2-1.5b", params=tree, engine=POLICY_ENGINE,
                  sched=POLICY_SCHED, requests=_policy_queue(),
                  drafter=None)]
    return keys, runs


_SPAWNED = {}


def _on_mesh(mesh_shape, tmp_path_factory):
    """Every run on ``mesh_shape``, once a module: {(kind, arch): rank 0's
    result}; every rank's streams equal."""
    if mesh_shape not in _SPAWNED:
        keys, runs = _runs()
        got = harness.spawn("serve_runs", mesh_shape[0] * mesh_shape[1],
                            tmp_path_factory.mktemp("mesh"), limit_s=240,
                            mesh_shape=mesh_shape, runs=runs)
        for r in got[1:]:
            assert [x["streams"] for x in r] == [x["streams"] for x in got[0]]
        _SPAWNED[mesh_shape] = dict(zip(keys, got[0]))
    return _SPAWNED[mesh_shape]


_ONE = {}


def _one_device(kind, arch, dtype=torch.float32):
    """The same run on one device (plain tensors, the test's process):
    (streams, scheduler counts, each decode step's logits)."""
    if (kind, arch, dtype) not in _ONE:
        from repro_torch.serve import ModelDrafter, SamplingParams
        cfg = smoke_variant(get_config(arch))
        eng_kw = {"contiguous": CONTIG, "paged": PAGED, "sampled": PAGED,
                  "policies": POLICY_ENGINE}.get(
            kind, dict(PAGED, prefill_chunk=0))
        eng = InferenceEngine(cfg, device="cpu", dtype=dtype, **eng_kw)
        params = params_from_jax(jax.tree.map(np.asarray, jtfm.init(
            j_smoke_variant(j_get_config(arch)), jax.random.key(0))))
        drafter = None
        if kind == "model":
            drafter = ModelDrafter(cfg, params, slots=4, max_len=16,
                                   page_size=4, catch_up_chunk=4,
                                   dtype=torch.float32, device="cpu")
        elif kind == "spec":
            truth = _one_device("contiguous", arch)[0]
            drafter = harness.ScriptedDrafter(
                {p.tobytes(): truth[i]
                 for i, (p, _, _) in enumerate(_queue(arch))},
                cfg.vocab_size, 2)
        logits = harness.record_decode_logits(eng)
        sched = Scheduler(eng, eng.init_state(params), drafter=drafter,
                          spec_k=3 if kind in ("spec", "model") else 0,
                          **(POLICY_SCHED if kind == "policies" else {}))
        queue = _policy_queue() if kind == "policies" else \
            _queue(arch, sampled=kind == "sampled")
        reqs = [Request(rid=i, prompt=p, max_new=n,
                        sampling=SamplingParams(**s) if s else
                        SamplingParams())
                for i, (p, n, s) in enumerate(queue)]
        out = sched.run(reqs)
        _ONE[(kind, arch, dtype)] = (
            {k: list(map(int, v)) for k, v in out.items()},
            dict(sched.stats), logits)
    return _ONE[(kind, arch, dtype)]


MESHES = [(2, 2), (4, 2)]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_paged_vs_contiguous_on_mesh(arch, mesh_shape, tmp_path_factory):
    """Paged with chunks equals contiguous on the mesh, and both equal
    one device's streams (the reference's acceptance bar)."""
    got = _on_mesh(mesh_shape, tmp_path_factory)
    contiguous = got[("contiguous", arch)]["streams"]
    paged = got[("paged", arch)]
    assert paged["streams"] == contiguous
    assert paged["stats"]["prefill_chunks"] > 0
    assert contiguous == _one_device("contiguous", arch)[0]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_decode_logits_on_mesh_match_one_device(kind, arch, mesh_shape,
                                                tmp_path_factory):
    """Every decode step's logits on the mesh within 1e-5 of their scale
    of one device's, both in float64, where only the float32 sections the
    reference keeps (the norms, the RG-LRU's gates and state) round: the
    paged-attention wrapper's head plans, its gathered offsets (qwen2's
    and recurrentgemma's one KV head on a model axis of 2: the
    ``cache_seq`` branch) or split KV heads (gemma2's two), each shard's
    sink and the ring's ``attend_masked``, held by value, not only through
    the argmax."""
    got = _on_mesh(mesh_shape, tmp_path_factory)[(f"{kind} float64", arch)]
    streams, _, want = _one_device(kind, arch, torch.float64)
    assert got["streams"] == streams
    got, want = np.concatenate(got["decode_logits"]), np.concatenate(want)
    assert got.shape == want.shape and np.isfinite(want).all()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_spec_parity_on_mesh(arch, mesh_shape, tmp_path_factory):
    got = _on_mesh(mesh_shape, tmp_path_factory)
    spec = got[("spec", arch)]
    assert spec["streams"] == got[("contiguous", arch)]["streams"]
    assert spec["stats"]["spec_accepted"] > 0
    one = _one_device("spec", arch)[1]
    for key in ("spec_proposed", "spec_accepted", "spec_steps",
                "decode_steps", "decode_tokens"):
        assert spec["stats"][key] == one[key], key


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_sampled_stream_on_mesh_equals_one_device(mesh_shape,
                                                  tmp_path_factory):
    got = _on_mesh(mesh_shape, tmp_path_factory)[("sampled", "qwen2-1.5b")]
    want = _one_device("sampled", "qwen2-1.5b")[0]
    assert got["streams"] == want
    greedy = _one_device("paged", "qwen2-1.5b")[0]
    assert got["streams"] != greedy                   # it did sample


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_model_drafter_on_mesh(mesh_shape, tmp_path_factory):
    """The target drafting for itself on the mesh: every draft accepted,
    the streams the mesh's spec_k=0 ones."""
    got = _on_mesh(mesh_shape, tmp_path_factory)
    run = got[("model", "qwen2-1.5b")]
    assert run["streams"] == got[("contiguous", "qwen2-1.5b")]["streams"]
    assert run["stats"]["spec_accepted"] == run["stats"]["spec_proposed"] > 0


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_state_on_mesh_placed_by_rule_tables(mesh_shape, tmp_path_factory):
    """The DTensor placements of the first run's state (qwen2-1.5b,
    contiguous) on the ranks equal what ``state_shardings`` resolves from
    the rule tables, which the stand-in tests hold to the reference's."""
    got = _on_mesh(mesh_shape, tmp_path_factory)[("contiguous",
                                                  "qwen2-1.5b")]
    cfg = smoke_variant(get_config("qwen2-1.5b"))
    eng = InferenceEngine(cfg, mesh=shd.MeshShape(("data", "model"),
                                                  mesh_shape),
                          device="cpu", dtype=torch.float32, **CONTIG)
    pl = eng.state_shardings(_plain_state(eng, cfg))
    want = {}
    for name, v in pl._asdict().items():
        if v is None:
            continue
        for k, p in _flat_pl(v, name).items():
            want[k] = str(tuple(p))
    assert got["placements"] == want
    assert got["placements"]["positions"].startswith("(Shard(dim=0)")


def _flat_pl(tree, key):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {key: tree}
    out = {}
    for k, v in items:
        out.update(_flat_pl(v, f"{key}/{k}"))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_prefix_cache_and_preemption_on_mesh(mesh_shape, tmp_path_factory):
    """The page hooks on local blocks: prefix hits with copy-on-write and
    preemption's swap out and in on a pool split over "data" give the
    one-device streams and counts."""
    got = _on_mesh(mesh_shape, tmp_path_factory)[("policies", "qwen2-1.5b")]
    want, stats, _ = _one_device("policies", "qwen2-1.5b")
    assert got["streams"] == want
    for key in ("prefix_hits", "prefix_hit_tokens", "cow_pages",
                "preemptions", "restores", "deferred_admissions"):
        assert got["stats"][key] == stats[key], key
    assert stats["prefix_hits"] > 0 and stats["preemptions"] > 0
