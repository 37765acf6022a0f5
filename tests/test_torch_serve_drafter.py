"""The port's ``ModelDrafter`` against the reference's, on the CPU at
smoke size in float32 (the harness is in ``torch_serve_parity.py``).

The cases mirror ``tests/test_serve_speculative.py``: a draft model with
the target's own params proposes the target's own greedy continuation,
so every draft is accepted — reachable only if the drafter's committed
state stays exactly in sync through its catch-up chunks and the rollout
it undoes in place (the port's steps do not donate a copy, as the
reference's do), recurrent rows included on the hybrid; a draft model
with other params is rejected more often and changes no stream; and a
recycled slot whose ``release`` was missed is caught by the committed
prefix, not by lengths. Streams, proposals and the speculation counts
must equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_serve_parity as parity  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import ModelDrafter as JModelDrafter  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ModelDrafter  # noqa: E402

torch.set_num_threads(1)
SPEC_K = 3
PAGED = dict(slots=2, max_len=16, page_size=4)
LENS = [8, 5, 7, 6]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")


def _specs(arch, lens=LENS, gen=6):
    rng = np.random.default_rng(0)
    v = parity.cfgs(arch)[1].vocab_size
    return [parity.spec(rng.integers(0, v, n), gen) for n in lens]


def _tree(arch, seed):
    return jax.tree.map(np.asarray,
                        jtfm.init(parity.cfgs(arch)[0], jax.random.key(seed)))


def _drafters(arch, tree, max_len=16 + SPEC_K, slots=2, **kw):
    """The reference's and the port's draft model on ``tree``."""
    jcfg, cfg = parity.cfgs(arch)
    jd = JModelDrafter(jcfg, params=jax.tree.map(jnp.asarray, tree),
                       mesh=parity._mesh(), slots=slots, max_len=max_len,
                       page_size=4, dtype=jnp.float32, **kw)
    d = ModelDrafter(cfg, params=params_from_jax(tree), slots=slots,
                     max_len=max_len, page_size=4, dtype=torch.float32,
                     device="cpu", **kw)
    return jd, d


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-2b"])
def test_model_drafter_self_draft_full_acceptance(arch):
    """test_serve_speculative.py:140."""
    tree = parity.params(arch)
    ref, base = parity.serve_both(arch, tree, _specs(arch), engine_kw=PAGED)
    got, st = parity.serve_both(arch, tree, _specs(arch), engine_kw=PAGED,
                                sched_kw={"spec_k": SPEC_K},
                                drafters=_drafters(arch, tree))
    assert got == ref
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == st["spec_proposed"], st
    assert st["decode_tokens"] > st["decode_steps"]
    assert st["decode_steps"] < base["decode_steps"]


def test_model_drafter_desynced_params_still_lossless():
    """test_serve_speculative.py:162: a drafter with other params (the
    reference's init at key 99) changes no stream; its acceptance counts
    equal the reference drafter's."""
    arch = "olmo-1b"
    tree = parity.params(arch)
    ref, _ = parity.serve_both(arch, tree, _specs(arch), engine_kw=PAGED)
    got, st = parity.serve_both(arch, tree, _specs(arch), engine_kw=PAGED,
                                sched_kw={"spec_k": SPEC_K},
                                drafters=_drafters(arch, _tree(arch, 99)))
    assert got == ref
    assert st["spec_accepted"] < st["spec_proposed"]


def test_model_drafter_survives_missed_release():
    """test_serve_speculative.py:242: a recycled slot whose new context is
    LONGER than the old committed position, with no ``release``: the
    proposals equal a fresh drafter's and the reference's."""
    arch = "olmo-1b"
    tree = parity.params(arch)
    v = parity.cfgs(arch)[1].vocab_size
    rng = np.random.default_rng(13)
    ctx_a = rng.integers(0, v, 10).astype(np.int32)
    ctx_b = np.concatenate(
        [ctx_a[:1], rng.integers(0, v, 11).astype(np.int32)])
    jstale, stale = _drafters(arch, tree, max_len=32, slots=1)
    for d in (jstale, stale):
        d.propose({0: (ctx_a, 3)})
    got = stale.propose({0: (ctx_b, 3)})
    want = jstale.propose({0: (ctx_b, 3)})
    fresh = _drafters(arch, tree, max_len=32, slots=1)[1].propose(
        {0: (ctx_b, 3)})
    assert got[0].tolist() == fresh[0].tolist() == want[0].tolist()


def test_model_drafter_rollout_leaves_committed_state():
    """The port's rollout writes the draft slots' positions, last tokens
    and recurrent rows back: after a propose of K=3, a second propose on
    the same context re-proposes the same tokens, and the committed rows
    equal a drafter that only caught up."""
    arch = "recurrentgemma-2b"
    tree = parity.params(arch)
    v = parity.cfgs(arch)[1].vocab_size
    ctx = np.random.default_rng(4).integers(0, v, 9).astype(np.int32)
    _, d = _drafters(arch, tree, max_len=32, slots=1)
    first = d.propose({0: (ctx, 3)})[0].tolist()
    rows = [t.clone() for t in d._rollout_rows()]
    assert d.propose({0: (ctx, 3)})[0].tolist() == first
    _, caught = _drafters(arch, tree, max_len=32, slots=1)
    caught.propose({0: (ctx, 1)})
    for a, b, c in zip(rows, d._rollout_rows(), caught._rollout_rows()):
        assert torch.equal(a, b) and torch.equal(b, c)
