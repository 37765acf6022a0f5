"""The port's paged attention (``repro_torch.kernels.paged_attn``) on the
CPU, where its wrapper computes the plain version, against the reference's
Pallas kernel run in interpret mode (``repro.kernels.paged_attn``).

The inputs, made with numpy, include unassigned pages, recycled entries
(``pos = -1``), a query at position -1 and a slot with no page at all, so
rows with nothing to attend to come out 0 on both sides. The kernel's split-K
algorithm (``paged_attention_split_ref``) is held against the plain
version, and the split planner against the card's SM count. Tolerances:
float32 within 2e-5, the reference's own kernel-vs-oracle bound; bfloat16
within 2e-2 on outputs of magnitude < 4 (one bfloat16 ulp there is
1.6e-2), since both round each score through bfloat16 and a score summed
in another order can round to the neighbouring value.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attn.ops import paged_attention_fused as j_fused  # noqa: E402
from repro.kernels.paged_attn.ref import paged_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.paged_attn.ops import (  # noqa: E402
    grid_of, paged_attention_fused, plan_splits)
from repro_torch.kernels.paged_attn.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)

torch.set_num_threads(1)
PS = 4
ATOL_F32 = 2e-5
ATOL_BF16 = 2e-2


def _case(seed, T, Hq, Hkv, D=16, n=4):
    """A shuffled pool and per-slot page rows for cached lengths
    [9, 6, 0, 13]; slot 2 owns no page, slot 3 has a recycled entry, and
    slot 0's first query sits at position -1 when T > 1."""
    rng = np.random.default_rng(seed)
    lens = [9, 6, 0, 13]
    B = len(lens)
    need = [-(-l // PS) for l in lens]
    P = sum(need) + 2
    perm = iter(rng.permutation(P))
    pos = np.full((P, PS), -1, np.int32)
    rows = np.full((B, n), -1, np.int32)
    for b, l in enumerate(lens):
        for j in range(need[b]):
            p = int(next(perm))
            rows[b, j] = p
            fill = min(PS, l - j * PS)
            pos[p, :fill] = np.arange(j * PS, j * PS + fill)
    pos[rows[3, 1], 1] = -1
    qpos = np.stack([np.arange(max(l, T) - T, max(l, T)) for l in lens])
    if T > 1:
        qpos[0, 0] = -1
    return dict(q=rng.normal(0, 1, (B, T, Hq, D)).astype(np.float32),
                k=rng.normal(0, 1, (P, PS, Hkv, D)).astype(np.float32),
                v=rng.normal(0, 1, (P, PS, Hkv, D)).astype(np.float32),
                pos=pos, rows=rows, qpos=qpos.astype(np.int32))


def _both(c, dtype, **kw):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = j_fused(jnp.asarray(c["q"], jd), jnp.asarray(c["k"], jd),
                   jnp.asarray(c["v"], jd), jnp.asarray(c["pos"]),
                   jnp.asarray(c["rows"]), jnp.asarray(c["qpos"]), **kw)
    got = paged_attention_fused(
        torch.tensor(c["q"]).to(td), torch.tensor(c["k"]).to(td),
        torch.tensor(c["v"]).to(td), torch.tensor(c["pos"]),
        torch.tensor(c["rows"]), torch.tensor(c["qpos"]), **kw)
    assert got.dtype == td and got.shape == c["q"].shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 50.0),
                                            (5, 50.0)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 1), (4, 2), (6, 2)])
@pytest.mark.parametrize("T", [1, 4, 7])
def test_plain_matches_jax_kernel(T, Hq, Hkv, window, softcap):
    c = _case(T * 100 + Hq * 10 + Hkv, T, Hq, Hkv)
    before = paged_attention_fused.launches
    for dtype, atol in (("f32", ATOL_F32), ("bf16", ATOL_BF16)):
        got, want = _both(c, dtype, window=window, softcap=softcap)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=dtype)
        assert not got[2].any()               # slot 2: nothing to attend
        if T > 1:
            assert not got[0, 0].any()        # query at position -1
    assert paged_attention_fused.launches == before   # CPU: no kernel


def test_plain_matches_jax_oracle_at_served_head_dim():
    """At qwen2-1.5b's GQA group (12 on 2) and head_dim 128, against the
    reference's jnp oracle as well (float32, where the two agree)."""
    c = _case(7, 4, 12, 2, D=128)
    got, want = _both(c, "f32")
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)
    B, T, Hq, D = c["q"].shape
    oracle = j_ref(jnp.asarray(c["q"]).reshape(B, T, 2, 6, D),
                   jnp.asarray(c["k"]), jnp.asarray(c["v"]),
                   jnp.asarray(c["pos"]), jnp.asarray(c["rows"]),
                   jnp.asarray(c["qpos"]))
    np.testing.assert_allclose(got, np.asarray(oracle).reshape(B, T, Hq, D),
                               atol=ATOL_F32, rtol=0)


def test_plain_rounds_scores_through_bf16():
    """The plain version follows the Pallas kernel in bfloat16: the score
    is rounded through q's dtype before the softmax. Without that rounding
    the output moves by more than the bfloat16 tolerance on these
    inputs (large scores), so the test can tell the two apart."""
    c = _case(11, 1, 4, 2)
    c["q"] *= 32.0
    got, want = _both(c, "bf16")
    np.testing.assert_allclose(got, want, atol=ATOL_BF16, rtol=0)
    args = [torch.tensor(c[k]).to(torch.bfloat16) for k in ("q", "k", "v")]
    args += [torch.tensor(c[k]) for k in ("pos", "rows", "qpos")]
    unrounded = paged_attention_ref(*[a.float() if a.is_floating_point()
                                      else a for a in args])
    unrounded = unrounded.to(torch.bfloat16).float().numpy()
    assert np.abs(unrounded - got).max() > ATOL_BF16


def test_wrapper_takes_cpu_tensors_only_through_plain_version():
    c = _case(3, 2, 4, 2)
    args = [torch.tensor(c[k]) for k in ("q", "k", "v", "pos", "rows",
                                         "qpos")]
    before = paged_attention_fused.launches
    out = paged_attention_fused(*args, window=3)
    torch.testing.assert_close(out, paged_attention_ref(*args, window=3),
                               atol=0, rtol=0)
    assert paged_attention_fused.launches == before
    with pytest.raises(ValueError, match="no kernel for device"):
        paged_attention_fused(*[a.to("meta") for a in args])


def _torch_args(c, dtype):
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return ([torch.tensor(c[k]).to(td) for k in ("q", "k", "v")]
            + [torch.tensor(c[k]) for k in ("pos", "rows", "qpos")])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 50.0),
                                            (3, 30.0)])
@pytest.mark.parametrize("pages_per_split", [1, 2, 3, 4, 5])
def test_split_ref_matches_plain(pages_per_split, window, softcap, dtype):
    """The split-K algorithm (per-split partials merged as the merge kernel
    merges them) equals the plain version within 1e-6, for splits of 1,
    2, 3, n and n+1 of the n=4 page columns: with unassigned pages, an
    empty slot, a query at position -1, windows of 5 and 3 that leave the
    first splits of slot 3 with no attendable key, a softcap, and bf16
    inputs, whose scores are rounded through bf16 on both sides."""
    c = _case(pages_per_split * 10 + window, 3, 4, 2)
    args = _torch_args(c, dtype)
    kw = dict(window=window, softcap=softcap)
    got = paged_attention_split_ref(*args, pages_per_split=pages_per_split,
                                    **kw)
    want = paged_attention_ref(*args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=0)
    assert not got[2].any() and not got[0, 0].any()
    if window:         # slot 3 (13 tokens): its first page is out of reach
        q3 = c["qpos"][3]
        assert (c["pos"][c["rows"][3, 0]] <= q3.min() - window).all()


# (B, T, Hq, Hkv, n): the decode and verify shapes of the served models,
# their page rows as long as chip_smoke.py's queues make them
SERVED = {"qwen2_decode": (4, 1, 12, 2, 36), "qwen2_verify": (4, 4, 12, 2, 36),
          "rg_decode": (4, 1, 10, 1, 162), "rg_verify": (4, 4, 10, 1, 162)}


@pytest.mark.parametrize("sms", [132, 114])      # H100 SXM and PCIe
@pytest.mark.parametrize("shape", sorted(SERVED))
def test_plan_splits_fills_the_card_at_decode_and_verify(shape, sms):
    B, T, Hq, Hkv, n = SERVED[shape]
    pps, splits, blocks = grid_of(B, T, Hq, Hkv, n, sms)
    assert blocks >= sms
    cols = [j for s in range(splits) for j in range(s * pps,
                                                    min(n, (s + 1) * pps))]
    assert cols == list(range(n))        # every page column exactly once


@pytest.mark.parametrize("Hq,Hkv,n", [(12, 2, 36), (10, 1, 162)])
def test_plan_splits_one_split_for_a_long_chunk(Hq, Hkv, n):
    """A 128-token chunk over 4 slots fills the card with its row tiles
    alone: one split, so no partials and no merge."""
    pps, splits, blocks = grid_of(4, 128, Hq, Hkv, n, 132)
    assert (pps, splits) == (n, 1) and blocks >= 132


def test_plan_splits_covers_every_column_once():
    for items in (1, 3, 8, 40, 200):
        for n in (1, 2, 5, 17, 36, 131, 162):
            for sms in (1, 78, 132):
                pps = plan_splits(items, 1, 1, n, sms)
                splits = -(-n // pps)
                assert 1 <= pps <= n
                assert (splits - 1) * pps < n <= splits * pps
                if items < sms and n >= -(-sms // items):
                    assert items * splits >= sms
                if items >= sms:
                    assert splits == 1
