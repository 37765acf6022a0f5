"""The port's Hopper kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip where there is no GPU. They import neither jax nor the
reference package, so they also run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32, atol 1e-5: the kernels sum in another order than PyTorch, except
the Pix-Con weights, which must agree to the bit (the partitioner ranks
pixels by them). Paged attention in bf16: atol 2e-2, one bf16 ulp at
|out| < 4, since a score summed in another order can round through bf16
to the neighbouring value.
"""
import pytest

torch = pytest.importorskip("torch")

ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(g, dev, *shape, s=1.0):
    return (torch.randn(shape, generator=g) * s).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,T,P", [(23, 1, 30, 64), (3, 5, 17, 48)])
@pytest.mark.parametrize("normalize,temperature", [(True, 1.0), (False, 2.5)])
def test_pixcon_kernel_matches_plain(dev, R, B, T, P, normalize, temperature):
    from repro_torch.kernels.pixcon import ops
    from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
    g = torch.Generator().manual_seed(R * B + T + P)
    a = dict(x=_rn(g, dev, R, B, T, P), feats=_rn(g, dev, R, B, P, 4),
             w1=_rn(g, dev, R, 4, 32, s=0.5), b1=_rn(g, dev, R, 32, s=0.1),
             w2=_rn(g, dev, R, 32, s=0.2), b2=_rn(g, dev, R, 1, s=0.1))
    before = ops.pixcon_gate.launches
    out, w = ops.pixcon_gate(**a, temperature=temperature, normalize=normalize)
    torch.cuda.synchronize()
    assert ops.pixcon_gate.launches == before + 1
    ref_out, ref_w = pixcon_gate_ref(**a, temperature=temperature,
                                     normalize=normalize)
    torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=0)
    torch.testing.assert_close(w, ref_w, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,D,H", [(23, 1, 128, 64), (23, 1, 64, 64),
                                     (3, 5, 48, 160)])
def test_lstm_cell_kernel_matches_plain(dev, R, B, D, H):
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
    g = torch.Generator().manual_seed(R + B + D + H)
    a = dict(x=_rn(g, dev, R, B, D), h=_rn(g, dev, R, B, H),
             c=_rn(g, dev, R, B, H), wx=_rn(g, dev, R, D, 4, H, s=D ** -0.5),
             wh=_rn(g, dev, R, H, 4, H, s=H ** -0.5),
             b=_rn(g, dev, R, 4, H, s=0.1))
    before = ops.lstm_cell_fused.launches
    h, c = ops.lstm_cell_fused(**a)
    torch.cuda.synchronize()
    assert ops.lstm_cell_fused.launches == before + 1
    ref_h, ref_c = lstm_cell_ref(**a)
    torch.testing.assert_close(h, ref_h, atol=ATOL, rtol=0)
    torch.testing.assert_close(c, ref_c, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    g = torch.Generator().manual_seed(0)
    x = _rn(g, dev, 2, 1, 8, 16)
    feats = _rn(g, dev, 2, 1, 16, 4)
    w = [_rn(g, dev, 2, 4, 8), _rn(g, dev, 2, 8), _rn(g, dev, 2, 8), _rn(g, dev, 2, 1)]
    with pytest.raises(TypeError, match="float32"):
        pixcon_gate(x.double(), feats, *w)
    with pytest.raises(ValueError, match="contiguous"):
        pixcon_gate(x.transpose(2, 3), feats, *w)
    with pytest.raises(ValueError, match="must be"):
        pixcon_gate(x, feats[:, :, :8].contiguous(), *w)
    with pytest.raises(ValueError, match="on cpu"):
        pixcon_gate(x, feats.cpu(), *w)
    hx = _rn(g, dev, 2, 1, 16)
    with pytest.raises(ValueError, match="must be"):
        lstm_cell_fused(_rn(g, dev, 2, 1, 8), hx, hx, _rn(g, dev, 2, 8, 4, 16),
                        _rn(g, dev, 2, 16, 4, 16), _rn(g, dev, 2, 4, 8))


def _paged_case(g, dev, dtype, B, T, Hq, Hkv, D, ps, n, lens):
    """A pool in shuffled page order with ``lens[b]`` cached tokens per
    slot, a recycled entry, unassigned pages and queries at the last T
    positions of each slot (a slot with no tokens attends to nothing)."""
    need = [-(-l // ps) for l in lens]
    P = sum(need) + 3
    perm = iter(torch.randperm(P, generator=g).tolist())
    pos = torch.full((P, ps), -1, dtype=torch.int32)
    rows = torch.full((B, n), -1, dtype=torch.int32)
    for b, l in enumerate(lens):
        for j in range(need[b]):
            p = next(perm)
            rows[b, j] = p
            fill = min(ps, l - j * ps)
            pos[p, :fill] = torch.arange(j * ps, j * ps + fill)
    if need[0] > 1:
        pos[rows[0, 1], 0] = -1
    qpos = torch.stack([torch.arange(max(l, T) - T, max(l, T)) for l in lens])
    return dict(q=_rn(g, dev, B, T, Hq, D).to(dtype),
                k_pool=_rn(g, dev, P, ps, Hkv, D).to(dtype),
                v_pool=_rn(g, dev, P, ps, Hkv, D).to(dtype),
                pos_pool=pos.to(dev), page_rows=rows.to(dev),
                qpos=qpos.to(torch.int32).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,Hq,Hkv,D,ps,window,softcap", [
    (1, 12, 2, 128, 16, 0, 0.0),       # qwen2-1.5b decode
    (4, 12, 2, 128, 16, 0, 0.0),       # verify, spec_k=3
    (128, 12, 2, 128, 16, 0, 0.0),     # a prefill chunk
    (7, 4, 1, 64, 4, 5, 50.0),         # window + softcap, small pages
    (3, 8, 8, 64, 32, 0, 30.0),        # no GQA, 32-key pages
    (2, 4, 2, 256, 8, 3, 0.0),
])
def test_paged_attn_kernel_matches_plain(dev, dtype, atol, T, Hq, Hkv, D, ps,
                                         window, softcap):
    """float32 within 1e-5 (sums in another order); bfloat16 within 2e-2,
    one bfloat16 ulp at |out| < 4 (a score can round the other way)."""
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    g = torch.Generator().manual_seed(T * 1000 + D + ps)
    lens = [37, 0, 5, 130]
    n = -(-max(lens) // ps) + 1
    a = _paged_case(g, dev, getattr(torch, dtype), 4, T, Hq, Hkv, D, ps, n,
                    lens)
    before = ops.paged_attention_fused.launches
    out = ops.paged_attention_fused(**a, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.paged_attention_fused.launches == before + 1
    ref = paged_attention_ref(**a, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    assert not out[1].any()            # slot 1 has no page


@pytest.mark.cuda
def test_paged_attn_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels.paged_attn.ops import paged_attention_fused
    g = torch.Generator().manual_seed(0)
    a = _paged_case(g, dev, torch.float32, 2, 1, 4, 2, 64, 4, 3, [5, 9])
    with pytest.raises(TypeError, match="int32"):
        paged_attention_fused(**{**a, "qpos": a["qpos"].long()})
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_attention_fused(**{**a, "q": a["q"].half()})
    with pytest.raises(ValueError, match="page size"):
        b = _paged_case(g, dev, torch.float32, 2, 1, 4, 2, 64, 6, 3, [5, 9])
        paged_attention_fused(**b)
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention_fused(**{**a, "q": a["q"][..., :48].contiguous(),
                                 "k_pool": a["k_pool"][..., :48].contiguous(),
                                 "v_pool": a["v_pool"][..., :48].contiguous()})
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_fused(**{**a, "q": a["q"].transpose(2, 3)
                                 .contiguous().transpose(2, 3)})
