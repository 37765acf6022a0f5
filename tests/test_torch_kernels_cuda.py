"""The port's Hopper kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip where there is no GPU. They import neither jax nor the
reference package, so they also run on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32, atol 1e-5: the kernels sum in another order than PyTorch, except
the Pix-Con weights, which must agree to the bit (the partitioner ranks
pixels by them). Paged attention and local attention (with and without
gemma2's softcap) in bf16: atol 2e-2, one bf16 ulp at
|out| < 4, since a score summed in another order can round through bf16
to the neighbouring value. The SSD chunk's bf16 y: one bf16 ulp at every
magnitude (``BF16_ULP``), since its outputs reach |y| ~ 140. Gradients
through the Pix-Con and LSTM autograd Functions (kernel forward, plain
backward): within 1e-4 of each leaf's largest |grad| (``GRAD_REL``), at
the training shapes.
"""
import pytest

torch = pytest.importorskip("torch")

ATOL = 1e-5
# One bf16 ulp at every magnitude: bf16 keeps 8 significant bits, so an
# ulp is 2^-7 of the lower edge of its binade (between 2^-8 and 2^-7 of
# |y|); below |y| = 4 the 2e-2 floor holds, as for the other kernels. A
# tensor-core product sums in another order than the plain version's, so
# a y that lies near a bf16 rounding boundary lands on the neighbouring
# value.
BF16_ULP = dict(atol=2e-2, rtol=2 ** -7)
GRAD_REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rn(g, dev, *shape, s=1.0):
    return (torch.randn(shape, generator=g) * s).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,T,P", [(23, 1, 30, 64), (3, 5, 17, 48),
                                     (23, 32, 30, 64), (23, 8, 30, 64),
                                     (1, 32, 30, 64)])
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


def _near_tie_inputs(g, dev, R, B, T, P):
    """Pix-Con inputs whose pixels come in pairs: the second of a pair has
    the first's features moved by one float32 ulp in one feature, so the
    two gate weights lie a few ulp apart (or tie)."""
    x = _rn(g, dev, R, B, T, P).abs()
    feats = _rn(g, dev, R, B, P, 4)
    f = feats[:, :, 0::2].clone()
    moved = f.clone()
    k = torch.arange(moved.shape[2], device=dev) % 4
    col = moved.gather(-1, k.view(1, 1, -1, 1).expand(R, B, -1, 1))
    moved.scatter_(-1, k.view(1, 1, -1, 1).expand(R, B, -1, 1),
                   torch.nextafter(col, torch.full_like(col, float("inf"))))
    feats[:, :, 1::2] = moved[:, :, :P // 2]
    return dict(x=x, feats=feats.contiguous(), w1=_rn(g, dev, R, 4, 32, s=0.5),
                b1=_rn(g, dev, R, 32, s=0.1), w2=_rn(g, dev, R, 32, s=0.2),
                b2=_rn(g, dev, R, 1, s=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,T,P", [(23, 1, 30, 64), (3, 2, 7, 50)])
def test_pixcon_near_ties_bit_equal(dev, R, B, T, P):
    """Pixels whose features differ in their last bit: w to the bit and the
    same ranking as the plain version (the partitioner sorts by w); P=50
    takes the scalar write path."""
    from repro_torch.kernels.pixcon import ops
    from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
    g = torch.Generator().manual_seed(P)
    a = _near_tie_inputs(g, dev, R, B, T, P)
    out, w = ops.pixcon_gate(**a)
    torch.cuda.synchronize()
    ref_out, ref_w = pixcon_gate_ref(**a)
    torch.testing.assert_close(w, ref_w, atol=0, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    assert torch.equal(torch.argsort(-w, dim=-1, stable=True),
                       torch.argsort(-ref_w, dim=-1, stable=True))


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,D,H", [(23, 1, 128, 64), (23, 1, 64, 64),
                                     # training: stacked, accumulated, sequential
                                     (23, 32, 128, 64), (23, 32, 64, 64),
                                     (23, 8, 128, 64), (1, 32, 64, 64),
                                     (3, 5, 48, 160), (1, 23, 128, 64),
                                     (4, 2, 7, 50),     # H not a multiple of 8
                                     (5, 3, 1, 64),     # D = 1
                                     (2, 3, 4000, 64)])  # K through the ring
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
    # recurrentgemma-2b's local layers (D=256, 16-token pages) in verify
    # and in a prefill chunk, the window short enough to mask keys here
    (4, 10, 1, 256, 16, 100, 0.0),
    (128, 10, 1, 256, 16, 100, 0.0),
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
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,Hq,Hkv,D,ps,window,softcap,n,pps", [
    # G=10 at D=256 (recurrentgemma-2b's local layers), decode: splits of
    # 2 pages, the first ones wholly outside slot 3's window (all dead)
    (1, 10, 1, 256, 16, 40, 0.0, 9, 2),
    (1, 10, 1, 256, 16, 40, 0.0, 9, 8),      # n = pps + 1: a 1-page split
    (1, 10, 1, 256, 16, 40, 0.0, 9, 10),     # n = pps - 1: one split, no merge
    (4, 10, 1, 256, 16, 0, 0.0, 10, 3),      # T*G = 40: tiles of 16, 16, 8
    (3, 5, 1, 64, 4, 7, 50.0, 34, 5),        # T*G = 15 < 16, a softcap
    (2, 12, 2, 128, 16, 0, 0.0, 9, 1),       # qwen2's heads, a page a split
    (5, 8, 8, 64, 32, 30, 0.0, 6, 2),        # 32-key pages (two key groups)
])
def test_paged_attn_split_edges(dev, monkeypatch, dtype, atol, T, Hq, Hkv, D,
                                ps, window, softcap, n, pps):
    """Page rows split over blocks at the split's edges, with the split
    forced: the merge of the partials against the plain version, one call
    counted once whether one or two kernels ran."""
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    monkeypatch.setattr(ops, "plan_splits", lambda *a: pps)
    g = torch.Generator().manual_seed(T * 100 + n + pps)
    a = _paged_case(g, dev, getattr(torch, dtype), 4, T, Hq, Hkv, D, ps, n,
                    [37, 0, 5, 130])
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


# ---------------------------------------------------------------------------
# conv1d, ssd_chunk and local attention: fp32 within 1e-5 (the conv1d
# kernel rounds each product and sum as its plain version does, so it
# agrees to the bit; the other two sum in another order); bf16 outputs
# within 2e-2, one bf16 ulp at |out| < 4, where a float32 result that
# differs in its last bit rounds to the neighbouring bf16 value.
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,C,K,act,tail", [
    (1, 512, 1792, 4, "silu", False),   # mamba2-130m prefill layer
    (4, 1, 1792, 4, "silu", True),      # mamba2-130m decode step
    (1, 2560, 2560, 4, "none", False),  # recurrentgemma-2b prefill layer
    (4, 4, 2560, 4, "none", True),      # recurrentgemma-2b verify step
    (2, 2050, 130, 3, "silu", True),    # S > 2,048, C not a multiple of 128
    (3, 2, 5, 4, "none", True),         # S < K-1: the tail is read twice
])
def test_conv1d_kernel_matches_plain(dev, dtype, atol, B, S, C, K, act, tail):
    from repro_torch.kernels.conv1d import ops
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    g = torch.Generator().manual_seed(B * S + C + K)
    td = getattr(torch, dtype)
    a = dict(x=_rn(g, dev, B, S, C).to(td), w=_rn(g, dev, K, C, s=0.5).to(td),
             b=_rn(g, dev, C, s=0.1).to(td),
             tail=_rn(g, dev, B, K - 1, C).to(td) if tail else None)
    before = ops.causal_conv1d.launches
    y, new_tail = ops.causal_conv1d(**a, activation=act)
    torch.cuda.synchronize()
    assert ops.causal_conv1d.launches == before + 1
    ref_y, ref_tail = causal_conv1d_ref(**a, activation=act)
    torch.testing.assert_close(y.float(), ref_y.float(), atol=atol, rtol=0)
    torch.testing.assert_close(new_tail, ref_tail, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case,B,S,C,K,act,tail,offset", [
    ("odd_offset", 2, 7, 1792, 4, "silu", True, 1),   # a view off alignment
    ("odd_offset_wide", 1, 128, 1792, 4, "silu", True, 1),  # ... vector-sized
    ("c1794", 1, 64, 1794, 4, "silu", True, 0),       # C not a multiple of 8
    ("c130", 2, 33, 130, 4, "none", True, 0),
    ("s1_tail", 3, 1, 256, 4, "silu", True, 0),       # S below K-1
    ("s2_tail", 3, 2, 256, 4, "none", True, 0),
    ("s3000", 1, 3000, 1792, 4, "silu", False, 0),
    ("k2", 2, 19, 512, 2, "none", True, 0),
    ("k5", 2, 19, 512, 5, "silu", True, 0),           # K re-read, not windowed
    ("k1", 2, 9, 64, 1, "silu", False, 0),            # no tail at all
])
def test_conv1d_kernel_edges(dev, monkeypatch, dtype, atol, case, B, S, C, K,
                             act, tail, offset):
    """The vector and scalar paths, the windowed and re-read K, and the
    new tail the kernel writes (bit-equal to the plain version's). An
    input off 16-byte alignment is launched on the scalar path."""
    from repro_torch.kernels.conv1d import ops
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    plans, real = [], ops.plan_conv

    def plan_conv(*args):
        plans.append(real(*args))
        return plans[-1]
    monkeypatch.setattr(ops, "plan_conv", plan_conv)
    g = torch.Generator().manual_seed(B * S + C + K + offset)
    td = getattr(torch, dtype)
    base = _rn(g, dev, offset + B * S * C).to(td)
    x = base[offset:].view(B, S, C)
    assert x.is_contiguous() and x.storage_offset() == offset
    a = dict(x=x, w=_rn(g, dev, K, C, s=0.5).to(td),
             b=_rn(g, dev, C, s=0.1).to(td),
             tail=_rn(g, dev, B, K - 1, C).to(td) if tail else None)
    before = ops.causal_conv1d.launches
    y, new_tail = ops.causal_conv1d(**a, activation=act)
    torch.cuda.synchronize()
    assert ops.causal_conv1d.launches == before + 1
    if offset * x.element_size() % 16:
        assert not plans[-1].vector
    ref_y, ref_tail = causal_conv1d_ref(**a, activation=act)
    torch.testing.assert_close(y.float(), ref_y.float(), atol=atol, rtol=0)
    assert new_tail.dtype == td and tuple(new_tail.shape) == (B, K - 1, C)
    torch.testing.assert_close(new_tail, ref_tail, atol=0, rtol=0)


@pytest.mark.cuda
def test_conv1d_kernel_refuses_a_vector_plan_off_alignment(dev, monkeypatch):
    """The launch function checks the plan it is given: 16-byte vectors on
    an input off 16-byte alignment raise instead of reading misaligned."""
    from repro_torch.kernels.conv1d import ops
    B, S, C = 1, 128, 1792
    vector = ops.plan_conv(B, S, C, 2, True, 132)
    assert vector.vector
    monkeypatch.setattr(ops, "plan_conv", lambda *args: vector)
    g = torch.Generator().manual_seed(5)
    x = _rn(g, dev, 1 + B * S * C).bfloat16()[1:].view(B, S, C)
    w = _rn(g, dev, 4, C).bfloat16()
    b = _rn(g, dev, C).bfloat16()
    with pytest.raises(RuntimeError, match="invalid argument"):
        ops.causal_conv1d(x, w, b, activation="silu")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_replay_in_a_cuda_graph(dev):
    """Four wrappers captured into one CUDA graph (as the forecast is):
    the replay gives the eager call's outputs, to the bit."""
    from repro_torch.kernels.conv1d.ops import causal_conv1d
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
    g = torch.Generator().manual_seed(7)
    conv = dict(x=_rn(g, dev, 4, 1, 1792).bfloat16(),
                w=_rn(g, dev, 4, 1792, s=0.5).bfloat16(),
                b=_rn(g, dev, 1792, s=0.1).bfloat16(),
                tail=_rn(g, dev, 4, 3, 1792).bfloat16())
    lstm = dict(x=_rn(g, dev, 23, 1, 128), h=_rn(g, dev, 23, 1, 64),
                c=_rn(g, dev, 23, 1, 64),
                wx=_rn(g, dev, 23, 128, 4, 64, s=128 ** -0.5),
                wh=_rn(g, dev, 23, 64, 4, 64, s=0.125),
                b=_rn(g, dev, 23, 4, 64, s=0.1))
    pix = _near_tie_inputs(g, dev, 23, 1, 30, 64)
    ssd = ssd_inputs(g, dev, torch.bfloat16, 1, 2, 256, 24, 128, 64)

    def calls():
        return (*causal_conv1d(**conv, activation="silu"),
                *lstm_cell_fused(**lstm), *pixcon_gate(**pix),
                *ssd_chunk_fused(**ssd))
    eager = calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for o in outs:
        o.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(outs, eager):
        torch.testing.assert_close(o, e, atol=0, rtol=0)


def ssd_inputs(g, dev, dtype, B, nc, Q, H, N, P):
    """Model-like SSD inputs: C and B after the conv's SiLU, xdt = x * dt
    with dt = softplus(.), and the within-chunk cumsum of dt * A with
    A = -exp(U(-1, 1))."""
    import torch.nn.functional as F
    silu = lambda t: F.silu(t)
    dt = F.softplus(_rn(g, dev, B, nc, Q, H))
    A = -torch.exp(torch.rand(H, generator=g) * 2 - 1).to(dev)
    dA = (dt * A).permute(0, 1, 3, 2).contiguous()
    return dict(Cc=silu(_rn(g, dev, B, nc, Q, H, N)).to(dtype),
                Bc=silu(_rn(g, dev, B, nc, Q, H, N)).to(dtype),
                xdt=(_rn(g, dev, B, nc, Q, H, P) * dt[..., None]).to(dtype),
                dA_cs=torch.cumsum(dA, dim=-1).contiguous())


def _check_ssd(dev, dtype, B, nc, Q, H, N, P, seed):
    """One launch against the plain version: y within 1e-5 in float32 and
    one bf16 ulp in bf16 (``BF16_ULP``), the float32 state within 1e-5."""
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    g = torch.Generator().manual_seed(seed)
    a = ssd_inputs(g, dev, getattr(torch, dtype), B, nc, Q, H, N, P)
    before = ops.ssd_chunk_fused.launches
    y, st = ops.ssd_chunk_fused(**a)
    torch.cuda.synchronize()
    assert ops.ssd_chunk_fused.launches == before + 1
    ref_y, ref_st = ssd_chunk_ref(**a)
    tol = BF16_ULP if dtype == "bfloat16" else dict(atol=ATOL, rtol=0)
    torch.testing.assert_close(y.float(), ref_y.float(), **tol)
    torch.testing.assert_close(st, ref_st, atol=ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nc,Q,H,N,P", [
    (1, 2, 256, 24, 128, 64),   # mamba2-130m, a 512-token prefill
    (1, 1, 5, 24, 128, 64),     # a 5-token prompt: Q = 5
    (2, 1, 200, 3, 128, 64),    # Q not a multiple of the 64-row tile
    (1, 3, 8, 4, 16, 32),       # smoke widths
])
def test_ssd_chunk_kernel_matches_plain(dev, dtype, B, nc, Q, H, N, P):
    _check_ssd(dev, dtype, B, nc, Q, H, N, P, Q * H + N + P)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [24, 64])
@pytest.mark.parametrize("N", [16, 20, 128])
@pytest.mark.parametrize("Q", [1, 15, 16, 17, 63, 64, 65, 129, 200, 256])
def test_ssd_chunk_tile_edges(dev, dtype, Q, N, P):
    """Chunk lengths on each side of the 16-row warp tile and the 64-row
    query and key tiles, N below, off and on the 16-wide k-step (N=20
    takes element loads), P off the 16-wide output tile, over 2 batch rows
    of 2 chunks."""
    _check_ssd(dev, dtype, 2, 2, Q, 3, N, P, Q * 1000 + N * 10 + P)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", [
    (1, 2560, 10, 1, 256, 2048, True),  # recurrentgemma-2b, longest prompt
    (1, 600, 10, 1, 256, 2048, True),   # window >= S
    (2, 100, 4, 4, 64, 16, False),      # non-causal, no grouping
    (1, 77, 8, 2, 128, 33, True),       # S not a tile multiple, GQA
    (2, 77, 8, 1, 128, 33, False),      # non-causal MQA
])
def test_local_attn_kernel_matches_plain(dev, dtype, atol, B, S, Hq, Hkv, D,
                                         window, causal):
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    g = torch.Generator().manual_seed(S + D + window)
    td = getattr(torch, dtype)
    a = dict(q=_rn(g, dev, B, S, Hq, D).to(td), k=_rn(g, dev, B, S, Hkv, D).to(td),
             v=_rn(g, dev, B, S, Hkv, D).to(td))
    before = ops.local_attention_fused.launches
    out = ops.local_attention_fused(**a, window=window, causal=causal)
    torch.cuda.synchronize()
    assert ops.local_attention_fused.launches == before + 1
    ref = local_attention_ref(**a, window=window, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,causal", [
    (1, 4608, 8, 4, 256, 4096, True),   # gemma2-2b, longest prompt
    (1, 1024, 8, 4, 256, 4096, True),   # window >= S
    (2, 77, 8, 2, 128, 33, True),       # S not a tile multiple, GQA
    (2, 77, 8, 1, 64, 33, False),       # non-causal MQA
])
def test_local_attn_softcap_matches_plain(dev, dtype, atol, B, S, Hq, Hkv, D,
                                          window, causal):
    """gemma2's attention softcap of 50, with q scaled by 4 so that the
    scores reach ~20 and the cap moves the output: within the kernel's
    tolerances (fp32 1e-5, bf16 2e-2). Attention that peaked makes an
    output nearly one entry of v, so v is halved: every |out| stays under
    4, where 2e-2 exceeds one bf16 ulp (past 4 an ulp is 2^-5, and two
    correct roundings of one float32 result near a midpoint part by it)."""
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    g = torch.Generator().manual_seed(S + D + window + 50)
    td = getattr(torch, dtype)
    a = dict(q=_rn(g, dev, B, S, Hq, D, s=4.0).to(td),
             k=_rn(g, dev, B, S, Hkv, D).to(td),
             v=_rn(g, dev, B, S, Hkv, D, s=0.5).to(td))
    kw = dict(window=window, causal=causal)
    before = ops.local_attention_fused.launches
    out = ops.local_attention_fused(**a, **kw, softcap=50.0)
    torch.cuda.synchronize()
    assert ops.local_attention_fused.launches == before + 1
    ref = local_attention_ref(**a, **kw, softcap=50.0)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    uncapped = local_attention_ref(**a, **kw)
    assert (ref.float() - uncapped.float()).abs().max() > 0.5 * 5e-2  # v/2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", ATOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,Hq,Hkv,D,window,softcap,lens", [
    # gemma2-2b mid-decode of its whole-prefill queue: a local layer
    # (window 4,096) and a global one, softcap 50; and a verify step
    (1, 8, 4, 256, 4096, 50.0, [4624, 4316, 1040, 528]),
    (1, 8, 4, 256, 0, 50.0, [4624, 4316, 1040, 528]),
    (4, 8, 4, 256, 4096, 50.0, [4624, 4316, 1040, 528]),
    # llama3.2-3b (G=3) and olmo-1b (G=1) decode and verify
    (1, 24, 8, 128, 0, 0.0, [528, 526, 524, 522]),
    (4, 24, 8, 128, 0, 0.0, [528, 526, 524, 522]),
    (1, 16, 16, 128, 0, 0.0, [528, 526, 524, 522]),
])
def test_paged_attn_dense_decoder_shapes(dev, dtype, atol, T, Hq, Hkv, D,
                                         window, softcap, lens):
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    g = torch.Generator().manual_seed(T * 100 + Hq + window)
    n = -(-(max(lens) + 16) // 16)
    a = _paged_case(g, dev, getattr(torch, dtype), 4, T, Hq, Hkv, D, 16, n,
                    lens)
    before = ops.paged_attention_fused.launches
    out = ops.paged_attention_fused(**a, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.paged_attention_fused.launches == before + 1
    ref = paged_attention_ref(**a, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 63, 64, 65, 129])
def test_local_attn_bf16_tile_edges(dev, S, D, causal):
    """The bf16 kernel (tensor cores, 16-row warp tiles, 32- or 64-key
    tiles, 64-query blocks) at lengths on each side of its tile edges,
    with a window (33) that cuts key tiles: 2e-2, one bf16 ulp at |out| <
    4 (p is rounded to bf16 for P.V, ~2^-9 of the row's largest |v|)."""
    from repro_torch.kernels.local_attn import ops
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    g = torch.Generator().manual_seed(S * 10 + D + causal)
    a = {n: _rn(g, dev, 2, S, h, D).to(torch.bfloat16)
         for n, h in (("q", 4), ("k", 2), ("v", 2))}
    before = ops.local_attention_fused.launches
    out = ops.local_attention_fused(**a, window=33, causal=causal)
    torch.cuda.synchronize()
    assert ops.local_attention_fused.launches == before + 1
    ref = local_attention_ref(**a, window=33, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_new_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from repro_torch.kernels.conv1d.ops import causal_conv1d
    from repro_torch.kernels.local_attn.ops import local_attention_fused
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
    g = torch.Generator().manual_seed(0)
    x = _rn(g, dev, 2, 5, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        causal_conv1d(x, _rn(g, dev, 4, 8).bfloat16(), _rn(g, dev, 8))
    with pytest.raises(ValueError, match="must be"):
        causal_conv1d(x, _rn(g, dev, 4, 8), _rn(g, dev, 8),
                      tail=_rn(g, dev, 2, 2, 8))
    a = ssd_inputs(g, dev, torch.float32, 1, 1, 8, 2, 16, 8)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk_fused(**{**a, "dA_cs": a["dA_cs"].bfloat16()})
    with pytest.raises(ValueError, match="above"):
        b = ssd_inputs(g, dev, torch.float32, 1, 1, 8, 2, 16, 128)
        ssd_chunk_fused(**b)
    q = _rn(g, dev, 1, 9, 4, 48)
    with pytest.raises(ValueError, match="head_dim"):
        local_attention_fused(q, q[:, :, :2].contiguous(),
                              q[:, :, :2].contiguous(), window=4)
    q = _rn(g, dev, 1, 9, 4, 64)
    with pytest.raises(ValueError, match="contiguous"):
        local_attention_fused(q.transpose(1, 2).contiguous().transpose(1, 2),
                              q[:, :, :2].contiguous(), q[:, :, :2].contiguous(),
                              window=4)


def _grad_close(what, got, want):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert scale > 0 and err <= GRAD_REL * scale, (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B", [(23, 32), (23, 8), (1, 32)])
def test_pixcon_function_backward_matches_plain(dev, R, B):
    """The training route: gradients of a random linear function of the
    gated output (``w`` is non-differentiable), through the kernel's
    Function and through the plain version."""
    from repro_torch.kernels.pixcon import ops
    from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
    g = torch.Generator().manual_seed(R * B)
    a = dict(x=_rn(g, dev, R, B, 30, 64).abs(), feats=_rn(g, dev, R, B, 64, 4),
             w1=_rn(g, dev, R, 4, 32, s=0.5), b1=_rn(g, dev, R, 32, s=0.1),
             w2=_rn(g, dev, R, 32, s=0.2), b2=_rn(g, dev, R, 1, s=0.1))
    up = _rn(g, dev, R, B, 30, 64)
    grads = {}
    for fn in (ops.pixcon_gate, pixcon_gate_ref):
        leaves = {k: v.clone().requires_grad_(k not in ("x", "feats"))
                  for k, v in a.items()}
        before = ops.pixcon_gate.launches
        out, w = fn(**leaves)
        launched = ops.pixcon_gate.launches - before
        assert launched == (1 if fn is ops.pixcon_gate else 0)
        assert w.requires_grad == (fn is pixcon_gate_ref)
        (out * up).sum().backward()
        assert ops.pixcon_gate.launches - before == launched   # backward: none
        grads[fn] = {k: leaves[k].grad for k in ("w1", "b1", "w2", "b2")}
    for k, want in grads[pixcon_gate_ref].items():
        _grad_close(k, grads[ops.pixcon_gate][k], want)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,D", [(23, 32, 128), (23, 32, 64), (23, 8, 128),
                                   (1, 32, 64)])
def test_lstm_function_backward_matches_plain(dev, R, B, D):
    """Thirty steps of one layer, as the temporal block runs them; the
    gradients of every input through the kernel's Function and through the
    plain version."""
    from repro_torch.kernels.lstm_cell import ops
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
    H, T = 64, 30
    g = torch.Generator().manual_seed(R + B + D)
    a = dict(xs=_rn(g, dev, T, R, B, D), wx=_rn(g, dev, R, D, 4, H, s=D ** -0.5),
             wh=_rn(g, dev, R, H, 4, H, s=H ** -0.5), b=_rn(g, dev, R, 4, H, s=0.1))
    up = _rn(g, dev, R, B, H)
    grads = {}
    for fn in (ops.lstm_cell_fused, lstm_cell_ref):
        leaves = {k: v.clone().requires_grad_() for k, v in a.items()}
        h = torch.zeros(R, B, H, device=dev)
        c = torch.zeros_like(h)
        before = ops.lstm_cell_fused.launches
        for t in range(T):
            h, c = fn(leaves["xs"][t], h, c, leaves["wx"], leaves["wh"],
                      leaves["b"])
        (h * up).sum().backward()
        assert ops.lstm_cell_fused.launches - before == \
            (T if fn is ops.lstm_cell_fused else 0)
        grads[fn] = {k: v.grad for k, v in leaves.items()}
    for k, want in grads[lstm_cell_ref].items():
        _grad_close(k, grads[ops.lstm_cell_fused][k], want)


@pytest.mark.cuda
@pytest.mark.parametrize("R,B", [(23, 32), (1, 32)])
def test_domst_gradients_through_kernels_match_plain(dev, R, B):
    """``loss.backward()`` through ``domst.forward`` on the card gives every
    Pix-Con, spatial, LSTM and head leaf a gradient, within ``GRAD_REL`` of
    the plain run's, with the same pixel permutations."""
    from repro_torch.configs import get_config
    from repro_torch.core import domst
    from repro_torch.core.partitioner import partition_pixels
    from repro_torch.core.pixcon import pixcon_block
    cfg = get_config("domst")
    g = torch.Generator().manual_seed(7)
    params = {k: v.to(dev) for k, v in domst.init(cfg, g, R).items()}
    batch = {"precip": (torch.rand(R, B, 30, 64, generator=g) * 3).to(dev),
             "dist": torch.rand(R, B, 64, generator=g).to(dev),
             "target_day": (torch.rand(R, B, 64, generator=g) * 3).to(dev),
             "discharge": torch.randn(R, B, generator=g).to(dev)}
    orders, grads = [], []
    for ops in (domst.KERNELS, domst.PLAIN):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        x, w = pixcon_block(domst.subtree(leaves, "pixcon"), cfg.domst.pixcon,
                            batch["precip"], batch["dist"], batch["target_day"],
                            gate=ops.pixcon_gate)
        orders.append(partition_pixels(x, w, cfg.domst.num_heads)[1])
        loss, _ = domst.loss_fn(leaves, cfg, batch, ops)
        loss.sum().backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    assert torch.equal(orders[0], orders[1])
    assert grads[0].keys() == grads[1].keys() == params.keys()
    for k in params:
        assert grads[0][k] is not None, k
        _grad_close(k, grads[0][k], grads[1][k])
