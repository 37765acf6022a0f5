"""The host side of the conv1d, LSTM-step, Pix-Con, SSD-chunk,
local-attention and paged-attention wrappers, on the CPU: their input
checks, the launch plans they pass to ``csrc/conv1d.cu``,
``csrc/lstm_cell.cu``, ``csrc/ssd_chunk.cu`` and ``csrc/paged_attn.cu``
(``plan_conv``, ``plan_lstm``, ``plan_ssd``, ``grid_of``), and the
arguments they pack for a launch (the attention softcap as a float32
field). No card is needed: a CPU tensor that reports a
CUDA device takes the wrapper down its CUDA path, where the checks run and
the kernel library, absent here, raises (or a stand-in records the packed
arguments). Nothing of the reference package is imported."""
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import check_activations, check_inputs  # noqa: E402
from repro_torch.kernels.conv1d import ops as conv_ops  # noqa: E402
from repro_torch.kernels.local_attn import ops as local_ops  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.paged_attn import ops as paged_ops  # noqa: E402
from repro_torch.kernels.pixcon import ops as pixcon_ops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as ssd_ops  # noqa: E402

SMEM_LIMIT = 232448          # bytes of shared memory a block can use on an H100


class _OnCard(torch.Tensor):
    """A CPU tensor that reports CUDA device 0 wherever a wrapper asks."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _card(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).as_subclass(_OnCard)


@pytest.fixture
def no_library(monkeypatch):
    """A wrapper whose checks pass reaches the kernel library: here it
    raises instead of loading one."""
    def load(name):
        raise RuntimeError(f"no CUDA kernel library {name}")
    monkeypatch.setattr(build, "load", load)


def _raised(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the exception is the result
        return type(e), str(e)
    return None


# ---------------------------------------------------------------------------
# conv1d: each fault raises what ``check_activations`` raises for it
# ---------------------------------------------------------------------------
def _conv_inputs():
    return dict(x=_card(2, 5, 8), w=_card(4, 8, seed=1), b=_card(8, seed=2),
                tail=_card(2, 3, 8, seed=3))


CONV_FAULTS = {
    "w_float64": (TypeError, lambda a: {**a, "w": a["w"].double()}),
    "w_bf16_x_fp32": (TypeError, lambda a: {**a, "w": a["w"].bfloat16()}),
    "x_float16": (TypeError, lambda a: {k: v.half() for k, v in a.items()}),
    "x_not_contiguous": (ValueError, lambda a: {
        **a, "x": a["x"].transpose(1, 2).contiguous().transpose(1, 2)}),
    "tail_not_contiguous": (ValueError, lambda a: {
        **a, "tail": a["tail"].transpose(0, 1).contiguous().transpose(0, 1)}),
    "w_wrong_width": (ValueError, lambda a: {**a, "w": _card(4, 6)}),
    "b_wrong_shape": (ValueError, lambda a: {**a, "b": _card(9)}),
    "tail_wrong_shape": (ValueError, lambda a: {**a, "tail": _card(2, 2, 8)}),
    "w_on_cpu": (ValueError, lambda a: {**a, "w": torch.randn(4, 8)}),
    "tail_on_cpu": (ValueError, lambda a: {**a, "tail": torch.randn(2, 3, 8)}),
}


@pytest.mark.parametrize("fault", sorted(CONV_FAULTS))
def test_conv1d_checks_raise_as_before(no_library, fault):
    kind, make = CONV_FAULTS[fault]
    a = make(_conv_inputs())
    got = _raised(lambda: conv_ops.causal_conv1d(**a, activation="silu"))
    K, C = a["w"].shape[0], a["x"].shape[2]
    want = _raised(lambda: check_activations(
        "causal_conv1d", a, dict(w=(K, C), b=(C,), tail=(2, K - 1, C))))
    assert want is not None and want[0] is kind
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_tail", [False, True])
def test_conv1d_inputs_that_pass_reach_the_kernel(no_library, dtype, with_tail):
    a = {k: v.to(dtype) for k, v in _conv_inputs().items()}
    if not with_tail:
        a["tail"] = None
    before = conv_ops.causal_conv1d.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        conv_ops.causal_conv1d(**a)
    assert conv_ops.causal_conv1d.launches == before


# ---------------------------------------------------------------------------
# The LSTM step: each fault raises what ``check_inputs`` raises for it
# ---------------------------------------------------------------------------
def _lstm_inputs(R=2, B=1, D=8, H=16):
    return dict(x=_card(R, B, D), h=_card(R, B, H, seed=1),
                c=_card(R, B, H, seed=2), wx=_card(R, D, 4, H, seed=3),
                wh=_card(R, H, 4, H, seed=4), b=_card(R, 4, H, seed=5))


LSTM_FAULTS = {
    "h_bf16": (TypeError, lambda a: {**a, "h": a["h"].bfloat16()}),
    "wx_float64": (TypeError, lambda a: {**a, "wx": a["wx"].double()}),
    "wx_not_contiguous": (ValueError, lambda a: {
        **a, "wx": a["wx"].transpose(1, 3).contiguous().transpose(1, 3)}),
    "wh_wrong_shape": (ValueError, lambda a: {**a, "wh": _card(2, 16, 4, 8)}),
    "b_wrong_shape": (ValueError, lambda a: {**a, "b": _card(2, 4, 8)}),
    "c_on_cpu": (ValueError, lambda a: {**a, "c": torch.randn(2, 1, 16)}),
}


@pytest.mark.parametrize("fault", sorted(LSTM_FAULTS))
def test_lstm_checks_raise_as_before(no_library, fault):
    kind, make = LSTM_FAULTS[fault]
    a = make(_lstm_inputs())
    got = _raised(lambda: lstm_ops.lstm_cell_fused(**a))
    want = _raised(lambda: check_inputs(
        "lstm_cell_fused", a, dict(h=(2, 1, 16), c=(2, 1, 16),
                                   wx=(2, 8, 4, 16), wh=(2, 16, 4, 16),
                                   b=(2, 4, 16))))
    assert want is not None and want[0] is kind
    assert got == want


def test_lstm_inputs_that_pass_reach_the_kernel(no_library):
    before = lstm_ops.lstm_cell_fused.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        lstm_ops.lstm_cell_fused(**_lstm_inputs())
    assert lstm_ops.lstm_cell_fused.launches == before
    with pytest.raises(ValueError, match="exceeds"):
        lstm_ops.lstm_cell_fused(**_lstm_inputs(R=1, D=12 * 1024, H=4))


# ---------------------------------------------------------------------------
# Pix-Con: each fault raises what ``check_inputs`` raises for it
# ---------------------------------------------------------------------------
def _pixcon_inputs(R=2, B=3, T=5, P=8, F=4, Hp=6):
    return dict(x=_card(R, B, T, P), feats=_card(R, B, P, F, seed=1),
                w1=_card(R, F, Hp, seed=2), b1=_card(R, Hp, seed=3),
                w2=_card(R, Hp, seed=4), b2=_card(R, 1, seed=5))


PIXCON_FAULTS = {
    "x_bf16": (TypeError, lambda a: {**a, "x": a["x"].bfloat16()}),
    "w1_float64": (TypeError, lambda a: {**a, "w1": a["w1"].double()}),
    "x_not_contiguous": (ValueError, lambda a: {
        **a, "x": a["x"].transpose(2, 3).contiguous().transpose(2, 3)}),
    "feats_not_contiguous": (ValueError, lambda a: {
        **a, "feats": a["feats"].transpose(2, 3).contiguous()
        .transpose(2, 3)}),
    "feats_wrong_pixels": (ValueError, lambda a: {**a, "feats": _card(2, 3, 7, 4)}),
    "w1_wrong_replicas": (ValueError, lambda a: {**a, "w1": _card(3, 4, 6)}),
    "b1_wrong_shape": (ValueError, lambda a: {**a, "b1": _card(2, 5)}),
    "w2_wrong_shape": (ValueError, lambda a: {**a, "w2": _card(2, 7)}),
    "b2_wrong_shape": (ValueError, lambda a: {**a, "b2": _card(2)}),
    "b2_on_cpu": (ValueError, lambda a: {**a, "b2": torch.randn(2, 1)}),
}


@pytest.mark.parametrize("fault", sorted(PIXCON_FAULTS))
def test_pixcon_checks_raise_as_before(no_library, fault):
    kind, make = PIXCON_FAULTS[fault]
    a = make(_pixcon_inputs())
    got = _raised(lambda: pixcon_ops.pixcon_gate(**a, temperature=2.0))
    R, B, _, P = a["x"].shape
    F, Hp = a["w1"].shape[1:]
    want = _raised(lambda: check_inputs(
        "pixcon_gate", a, dict(feats=(R, B, P, F), w1=(R, F, Hp),
                               b1=(R, Hp), w2=(R, Hp), b2=(R, 1))))
    assert want is not None and want[0] is kind
    assert got == want


def test_pixcon_inputs_that_pass_reach_the_kernel(no_library):
    before = pixcon_ops.pixcon_gate.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        pixcon_ops.pixcon_gate(**_pixcon_inputs())
    assert pixcon_ops.pixcon_gate.launches == before
    with pytest.raises(ValueError, match="must be"):
        pixcon_ops.pixcon_gate(**{**_pixcon_inputs(), "x": _card(2, 3, 8)})
    with pytest.raises(ValueError, match="exceeds"):
        pixcon_ops.pixcon_gate(**_pixcon_inputs(R=1, B=1, T=1, P=8193))


# ---------------------------------------------------------------------------
# The SSD chunk: each fault raises what ``check_activations`` raises for it
# ---------------------------------------------------------------------------
def _ssd_inputs(B=1, nc=2, Q=5, H=3, N=16, P=8, dtype=torch.float32):
    return dict(Cc=_card(B, nc, Q, H, N, dtype=dtype),
                Bc=_card(B, nc, Q, H, N, dtype=dtype, seed=1),
                xdt=_card(B, nc, Q, H, P, dtype=dtype, seed=2),
                dA_cs=_card(B, nc, H, Q, seed=3))


SSD_FAULTS = {
    "xdt_float16": (TypeError, lambda a: {**a, "xdt": a["xdt"].half()}),
    "cc_bf16_xdt_fp32": (TypeError, lambda a: {**a, "Cc": a["Cc"].bfloat16()}),
    "da_bf16": (TypeError, lambda a: {**a, "dA_cs": a["dA_cs"].bfloat16()}),
    "bc_not_contiguous": (ValueError, lambda a: {
        **a, "Bc": a["Bc"].transpose(3, 4).contiguous().transpose(3, 4)}),
    "da_not_contiguous": (ValueError, lambda a: {
        **a, "dA_cs": a["dA_cs"].transpose(2, 3).contiguous()
        .transpose(2, 3)}),
    "bc_wrong_width": (ValueError, lambda a: {**a, "Bc": _card(1, 2, 5, 3, 12)}),
    "xdt_wrong_rows": (ValueError, lambda a: {**a, "xdt": _card(1, 2, 4, 3, 8)}),
    "da_wrong_shape": (ValueError, lambda a: {**a, "dA_cs": _card(1, 2, 3, 6)}),
    "bc_on_cpu": (ValueError, lambda a: {**a, "Bc": torch.randn(1, 2, 5, 3, 16)}),
}


@pytest.mark.parametrize("fault", sorted(SSD_FAULTS))
def test_ssd_chunk_checks_raise_as_before(no_library, fault):
    kind, make = SSD_FAULTS[fault]
    a = make(_ssd_inputs())
    got = _raised(lambda: ssd_ops.ssd_chunk_fused(**a))
    B, nc, Q, H, N = a["Cc"].shape
    P = a["xdt"].shape[4]
    want = _raised(lambda: check_activations(
        "ssd_chunk_fused", dict(xdt=a["xdt"], Cc=a["Cc"], Bc=a["Bc"],
                                dA_cs=a["dA_cs"]),
        dict(Cc=(B, nc, Q, H, N), Bc=(B, nc, Q, H, N), xdt=(B, nc, Q, H, P),
             dA_cs=(B, nc, H, Q)), fp32=("dA_cs",)))
    assert want is not None and want[0] is kind
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_inputs_that_pass_reach_the_kernel(no_library, dtype):
    before = ssd_ops.ssd_chunk_fused.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        ssd_ops.ssd_chunk_fused(**_ssd_inputs(dtype=dtype))
    assert ssd_ops.ssd_chunk_fused.launches == before
    with pytest.raises(ValueError, match="above"):
        ssd_ops.ssd_chunk_fused(**_ssd_inputs(P=65, dtype=dtype))
    with pytest.raises(ValueError, match="must be"):
        a = _ssd_inputs(dtype=dtype)
        ssd_ops.ssd_chunk_fused(**{**a, "xdt": a["xdt"][0]})


# ---------------------------------------------------------------------------
# Local attention: each fault raises what ``check_activations`` raises
# ---------------------------------------------------------------------------
def _local_inputs(B=1, S=6, Hq=4, Hkv=2, D=64, dtype=torch.float32):
    return dict(q=_card(B, S, Hq, D, dtype=dtype),
                k=_card(B, S, Hkv, D, dtype=dtype, seed=1),
                v=_card(B, S, Hkv, D, dtype=dtype, seed=2))


LOCAL_FAULTS = {
    "k_float64": (TypeError, lambda a: {**a, "k": a["k"].double()}),
    "k_bf16_q_fp32": (TypeError, lambda a: {**a, "k": a["k"].bfloat16()}),
    "q_float16": (TypeError, lambda a: {k: v.half() for k, v in a.items()}),
    "v_not_contiguous": (ValueError, lambda a: {
        **a, "v": a["v"].transpose(1, 2).contiguous().transpose(1, 2)}),
    "k_wrong_length": (ValueError, lambda a: {**a, "k": _card(1, 5, 2, 64)}),
    "v_wrong_heads": (ValueError, lambda a: {**a, "v": _card(1, 6, 1, 64)}),
    "v_on_cpu": (ValueError, lambda a: {**a, "v": torch.randn(1, 6, 2, 64)}),
}


@pytest.mark.parametrize("fault", sorted(LOCAL_FAULTS))
def test_local_attn_checks_raise_as_before(no_library, fault):
    kind, make = LOCAL_FAULTS[fault]
    a = make(_local_inputs())
    got = _raised(lambda: local_ops.local_attention_fused(**a, window=4))
    B, S, _, D = a["q"].shape
    Hkv = a["k"].shape[2]
    want = _raised(lambda: check_activations(
        "local_attention_fused", a, dict(k=(B, S, Hkv, D), v=(B, S, Hkv, D))))
    assert want is not None and want[0] is kind
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_attn_inputs_that_pass_reach_the_kernel(no_library, dtype):
    before = local_ops.local_attention_fused.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        local_ops.local_attention_fused(**_local_inputs(dtype=dtype),
                                        window=4, softcap=50.0)
    assert local_ops.local_attention_fused.launches == before
    with pytest.raises(ValueError, match="multiple"):
        local_ops.local_attention_fused(**_local_inputs(Hq=3, dtype=dtype),
                                        window=4)
    with pytest.raises(ValueError, match="head_dim"):
        local_ops.local_attention_fused(**_local_inputs(D=48, dtype=dtype),
                                        window=4)


@pytest.mark.parametrize("softcap", [-1.0, float("nan"), float("inf")])
@pytest.mark.parametrize("on_card", [True, False])
def test_attention_wrappers_refuse_a_bad_softcap(no_library, softcap,
                                                 on_card):
    """A negative, NaN or infinite softcap raises in both attention
    wrappers, on the CPU as on the card."""
    a = _local_inputs() if on_card else {
        k: torch.Tensor(v) for k, v in _local_inputs().items()}
    with pytest.raises(ValueError, match="softcap"):
        local_ops.local_attention_fused(**a, window=4, softcap=softcap)
    p = _paged_inputs()
    if not on_card:
        p = {k: torch.Tensor(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="softcap"):
        paged_ops.paged_attention_fused(**p, softcap=softcap)


# ---------------------------------------------------------------------------
# Paged attention: each fault raises what ``_check`` raises for it
# ---------------------------------------------------------------------------
def _paged_inputs(B=2, T=1, Hq=4, Hkv=2, D=64, ps=4, P=6, n=3,
                  dtype=torch.float32):
    pos = torch.arange(P * ps, dtype=torch.int32).view(P, ps)
    rows = torch.tensor([[0, 2, -1], [1, 3, 4]], dtype=torch.int32)[:B, :n]
    return dict(q=_card(B, T, Hq, D, dtype=dtype),
                k_pool=_card(P, ps, Hkv, D, dtype=dtype, seed=1),
                v_pool=_card(P, ps, Hkv, D, dtype=dtype, seed=2),
                pos_pool=pos.as_subclass(_OnCard),
                page_rows=rows.as_subclass(_OnCard),
                qpos=torch.full((B, T), 7, dtype=torch.int32).as_subclass(
                    _OnCard))


def _misaligned(t):
    flat = _card(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


PAGED_FAULTS = {
    "q_float16": (TypeError, lambda a: {**a, "q": a["q"].half()}),
    "k_pool_bf16_q_fp32": (TypeError, lambda a: {
        **a, "k_pool": a["k_pool"].bfloat16()}),
    "qpos_int64": (TypeError, lambda a: {**a, "qpos": a["qpos"].long()}),
    "page_rows_float": (TypeError, lambda a: {
        **a, "page_rows": a["page_rows"].float()}),
    "page_rows_not_contiguous": (ValueError, lambda a: {
        **a, "page_rows": a["page_rows"].t().contiguous().t()}),
    "v_pool_wrong_shape": (ValueError, lambda a: {
        **a, "v_pool": _card(6, 4, 1, 64)}),
    "pos_pool_wrong_shape": (ValueError, lambda a: {
        **a, "pos_pool": a["pos_pool"][:5]}),
    "qpos_wrong_shape": (ValueError, lambda a: {
        **a, "qpos": a["qpos"][:1]}),
    "page_rows_one_dim": (ValueError, lambda a: {
        **a, "page_rows": a["page_rows"][0]}),
    "page_rows_on_cpu": (ValueError, lambda a: {
        **a, "page_rows": torch.Tensor(a["page_rows"])}),
    "heads_not_a_multiple": (ValueError, lambda a: {
        **a, "q": _card(2, 1, 3, 64)}),
    "head_dim_48": (ValueError, lambda a: {
        **a, "q": _card(2, 1, 4, 48), "k_pool": _card(6, 4, 2, 48),
        "v_pool": _card(6, 4, 2, 48)}),
    "page_size_6": (ValueError, lambda a: {
        **a, "k_pool": _card(4, 6, 2, 64), "v_pool": _card(4, 6, 2, 64),
        "pos_pool": torch.zeros(4, 6, dtype=torch.int32).as_subclass(
            _OnCard)}),
    "q_misaligned": (ValueError, lambda a: {**a, "q": _misaligned(a["q"])}),
}


@pytest.mark.parametrize("fault", sorted(PAGED_FAULTS))
def test_paged_attn_checks_raise_as_before(no_library, fault):
    kind, make = PAGED_FAULTS[fault]
    a = make(_paged_inputs())
    got = _raised(lambda: paged_ops.paged_attention_fused(**a, window=5,
                                                          softcap=50.0))
    want = _raised(lambda: paged_ops._check(**a))
    assert want is not None and want[0] is kind
    assert got == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attn_inputs_that_pass_reach_the_kernel(no_library, dtype):
    a = _paged_inputs(dtype=dtype)
    assert paged_ops._fits(**a) and paged_ops._check(**a) is None
    before = paged_ops.paged_attention_fused.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        paged_ops.paged_attention_fused(**a, softcap=50.0)
    assert paged_ops.paged_attention_fused.launches == before


# ---------------------------------------------------------------------------
# What a wrapper packs for its launch: the tensors, the shape and the plan
# ---------------------------------------------------------------------------
class _Library:
    """Stands in for a kernel library: records the fields of each launch's
    packed argument (``fmt``, a ``struct`` format) and returns success."""

    def __init__(self, fmt):
        self.fmt, self.calls = fmt, []

    def __getattr__(self, name):        # conv1d_launch, lstm_cell_launch, ...
        def launch(packed):
            self.calls.append(struct.unpack(self.fmt, packed))
            return 0
        return launch


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers launch into a ``_Library``; their launch counts are put
    back afterwards (other tests read them from 0)."""
    libs = {conv_ops: _Library("17q"), lstm_ops: _Library("21q"),
            pixcon_ops: _Library("=18qf"), ssd_ops: _Library("21q"),
            local_ops: _Library("=14qf"), paged_ops: _Library("=20qf")}
    for fn in (conv_ops.causal_conv1d, lstm_ops.lstm_cell_fused,
               pixcon_ops.pixcon_gate, ssd_ops.ssd_chunk_fused,
               local_ops.local_attention_fused,
               paged_ops.paged_attention_fused):
        monkeypatch.setattr(fn, "launches", fn.launches)
    for ops, lib in libs.items():
        monkeypatch.setattr(ops, "_lib", lambda lib=lib: lib)
        if hasattr(ops, "sm_count"):
            monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
        monkeypatch.setattr(ops, "stream_handle", lambda dev: 0)
    return libs


@pytest.mark.parametrize("dtype,offset,vector", [
    (torch.bfloat16, 0, True), (torch.bfloat16, 1, False),
    (torch.float32, 0, True), (torch.float32, 1, False),
    (torch.float32, 4, True)])
def test_conv1d_launch_takes_the_scalar_plan_off_alignment(recorded, dtype,
                                                           offset, vector):
    """At a size where the plan takes 16-byte vectors (B=1, S=128,
    C=1,792), an input viewed at a storage offset that breaks 16-byte
    alignment is launched on the scalar path."""
    B, S, C, K = 1, 128, 1792, 4
    x = _card(offset + B * S * C, dtype=dtype)[offset:].view(B, S, C)
    assert x.is_contiguous() and x.storage_offset() == offset
    w, b = _card(K, C, dtype=dtype, seed=1), _card(C, dtype=dtype, seed=2)
    tail = _card(B, K - 1, C, dtype=dtype, seed=3)
    before = conv_ops.causal_conv1d.launches
    y, new_tail = conv_ops.causal_conv1d(x, w, b, activation="silu", tail=tail)
    assert conv_ops.causal_conv1d.launches == before + 1
    (a,) = recorded[conv_ops].calls
    assert a[:6] == (x.data_ptr(), tail.data_ptr(), w.data_ptr(),
                     b.data_ptr(), y.data_ptr(), new_tail.data_ptr())
    bf16 = dtype is torch.bfloat16
    assert a[6:11] == (B, S, C, K, 1 | (2 if bf16 else 0))
    p = conv_ops.plan_conv(B, S, C, x.element_size(), vector, 132)
    assert p.vector is vector
    assert a[13:] == (p.vector, p.run, p.runs, p.blocks)


@pytest.mark.parametrize("offset,vec16", [(0, True), (1, False)])
def test_lstm_launch_takes_its_plan(recorded, offset, vec16):
    """The forecast's first layer; wx viewed at a storage offset that
    breaks 16-byte alignment takes 4-byte copies."""
    R, B, D, H = 23, 1, 128, 64
    a = _lstm_inputs(R, B, D, H)
    a["wx"] = _card(offset + R * D * 4 * H, seed=3)[offset:].view(R, D, 4, H)
    h, c = lstm_ops.lstm_cell_fused(**a)
    (args,) = recorded[lstm_ops].calls
    assert args[:8] == (*(a[k].data_ptr() for k in ("x", "h", "c", "wx", "wh",
                                                    "b")),
                        h.data_ptr(), c.data_ptr())
    assert args[8:12] == (R, B, D, H)
    p = lstm_ops.plan_lstm(R, B, D, H, 132, vec16)
    assert p.vec16 is vec16
    assert args[14:] == tuple(p)


@pytest.mark.parametrize("offset,vec", [(0, True), (1, False)])
@pytest.mark.parametrize("normalize,temperature", [(True, 1.0), (False, 2.5),
                                                   (True, 0.3)])
def test_pixcon_launch_packs_its_fields(recorded, offset, vec, normalize,
                                        temperature):
    """The forecast's shape: pointers, shape, flags, and 1 / temperature as
    a float32 field (not cut to an integer); x viewed at a storage offset
    off 16-byte alignment takes the scalar write path."""
    R, B, T, P, F, Hp = 23, 1, 30, 64, 4, 32
    a = _pixcon_inputs(R, B, T, P, F, Hp)
    a["x"] = _card(offset + R * B * T * P)[offset:].view(R, B, T, P)
    before = pixcon_ops.pixcon_gate.launches
    out, w = pixcon_ops.pixcon_gate(**a, temperature=temperature,
                                    normalize=normalize)
    assert pixcon_ops.pixcon_gate.launches == before + 1
    assert out.shape == (R, B, T, P) and w.shape == (R, B, P)
    (f,) = recorded[pixcon_ops].calls
    assert f[:8] == (*(a[k].data_ptr() for k in ("x", "feats", "w1", "b1",
                                                 "w2", "b2")),
                     out.data_ptr(), w.data_ptr())
    assert f[8:14] == (R, B, T, P, F, Hp)
    assert f[14:18] == (normalize, vec, 0, 0)
    assert f[18] == np.float32(1.0 / temperature)


def test_pixcon_launch_takes_the_scalar_path_off_four_pixels(recorded):
    pixcon_ops.pixcon_gate(**_pixcon_inputs(P=10))
    (f,) = recorded[pixcon_ops].calls
    assert f[11] == 10 and f[15] == 0


@pytest.mark.parametrize("dtype,offset", [
    (torch.bfloat16, 0), (torch.bfloat16, 1), (torch.float32, 0),
    (torch.float32, 2)])
def test_ssd_chunk_launch_packs_its_fields(recorded, dtype, offset):
    """mamba2-130m's prefill layer: pointers, shape, dtype flag and the
    plan; xdt viewed at a storage offset off 16-byte alignment takes
    element loads."""
    B, nc, Q, H, N, P = 1, 2, 256, 24, 128, 64
    a = _ssd_inputs(B, nc, Q, H, N, P, dtype=dtype)
    n = B * nc * Q * H * P
    a["xdt"] = _card(offset + n, dtype=dtype)[offset:].view(B, nc, Q, H, P)
    before = ssd_ops.ssd_chunk_fused.launches
    y, st = ssd_ops.ssd_chunk_fused(**a)
    assert ssd_ops.ssd_chunk_fused.launches == before + 1
    assert y.dtype == dtype and y.shape == (B, nc, Q, H, P)
    assert st.dtype == torch.float32 and st.shape == (B, nc, H, P, N)
    (f,) = recorded[ssd_ops].calls
    assert f[:6] == (*(a[k].data_ptr() for k in ("Cc", "Bc", "xdt", "dA_cs")),
                     y.data_ptr(), st.data_ptr())
    bf16 = dtype is torch.bfloat16
    assert f[6:14] == (B * nc, Q, H, N, P, int(bf16), 0, 0)
    p = ssd_ops.plan_ssd(B * nc, Q, H, N, P, 2 if bf16 else 4, offset == 0)
    assert f[14:] == tuple(p)
    assert p.vec is (offset == 0)
    assert p.ksteps == (8 if bf16 else 0)
    assert p.qtiles == (8 if bf16 else 4) and p.state_first is bf16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("softcap,causal", [(0.0, True), (50.0, True),
                                            (30.5, False)])
def test_local_attn_launch_packs_its_fields(recorded, dtype, softcap, causal):
    """gemma2-2b's local layer (8 query heads on 4, D=256) at a ragged S:
    pointers, shape, window, causal, dtype flag, and the softcap as a
    float32 field after them."""
    a = _local_inputs(B=2, S=37, Hq=8, Hkv=4, D=256, dtype=dtype)
    before = local_ops.local_attention_fused.launches
    out = local_ops.local_attention_fused(**a, window=16, causal=causal,
                                          softcap=softcap)
    assert local_ops.local_attention_fused.launches == before + 1
    assert out.dtype == dtype and out.shape == a["q"].shape
    (f,) = recorded[local_ops].calls
    assert f[:4] == (a["q"].data_ptr(), a["k"].data_ptr(), a["v"].data_ptr(),
                     out.data_ptr())
    assert f[4:14] == (2, 37, 8, 4, 256, 16, int(causal),
                       int(dtype is torch.bfloat16), 0, 0)
    assert f[14] == np.float32(softcap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,D,n,window,softcap", [
    (4, 1, 8, 4, 256, 290, 4096, 50.0),   # gemma2-2b decode: split rows
    (1, 128, 8, 4, 256, 290, 0, 50.0),    # a gemma2 chunk of a global layer
    (4, 4, 24, 8, 128, 36, 0, 0.0),       # llama3.2-3b verify, G=3
    (4, 1, 16, 16, 128, 36, 0, 0.0),      # olmo-1b decode, G=1
])
def test_paged_attn_launch_packs_its_fields(recorded, dtype, B, T, Hq, Hkv,
                                            D, n, window, softcap):
    """Pointers (the split-K scratch where the plan splits the rows, else
    0), shape, the plan of ``grid_of`` on 132 SMs, window, dtype flag and
    the softcap as a float32 field."""
    ps, P = 16, n * B + 1
    rows = torch.arange(B * n, dtype=torch.int32).view(B, n)
    a = dict(q=_card(B, T, Hq, D, dtype=dtype),
             k_pool=_card(P, ps, Hkv, D, dtype=dtype, seed=1),
             v_pool=_card(P, ps, Hkv, D, dtype=dtype, seed=2),
             pos_pool=torch.zeros(P, ps, dtype=torch.int32).as_subclass(
                 _OnCard),
             page_rows=rows.as_subclass(_OnCard),
             qpos=torch.zeros(B, T, dtype=torch.int32).as_subclass(_OnCard))
    before = paged_ops.paged_attention_fused.launches
    out = paged_ops.paged_attention_fused(**a, window=window, softcap=softcap)
    assert paged_ops.paged_attention_fused.launches == before + 1
    assert out.dtype == dtype and out.shape == a["q"].shape
    (f,) = recorded[paged_ops].calls
    pps, splits, _ = paged_ops.grid_of(B, T, Hq, Hkv, n, 132)
    assert f[:7] == (*(a[k].data_ptr() for k in (
        "q", "k_pool", "v_pool", "pos_pool", "page_rows", "qpos")),
        out.data_ptr())
    assert (f[7] != 0) is (splits > 1)
    assert f[8:20] == (B, T, Hkv, Hq // Hkv, D, n, ps, pps, window,
                       int(dtype is torch.bfloat16), 0, 0)
    assert f[20] == np.float32(softcap)


# ---------------------------------------------------------------------------
# plan_ssd
# ---------------------------------------------------------------------------
SSD_SHAPES = [(2, 256, 24, 128, 64), (1, 5, 24, 128, 64), (2, 200, 3, 128, 64),
              (3, 8, 4, 16, 32), (4, 1, 3, 20, 24), (4, 129, 3, 16, 24),
              (20, 256, 24, 128, 64), (1, 65, 2, 256, 64), (2, 17, 1, 1, 1),
              (1, 300, 2, 200, 40)]


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("BN,Q,H,N,P", SSD_SHAPES)
def test_plan_ssd_covers_every_tile_and_slice_once(BN, Q, H, N, P, esize):
    """Decoding each block as the kernel does (``block_work``) gives every
    (query tile, head, batch*chunk) one y block, the tiles with the most
    key tiles first, and every (p, n) of every (head, batch*chunk) one
    state block."""
    p = ssd_ops.plan_ssd(BN, Q, H, N, P, esize, True)
    assert p.y_blocks == p.qtiles * H * BN
    tile = ssd_ops.TILE[esize]
    assert p.qtiles * tile >= Q > (p.qtiles - 1) * tile
    ns = p.blocks - p.y_blocks
    i = np.arange(p.blocks, dtype=np.int64)
    b = np.where(i < ns, i + p.y_blocks, i - ns) if p.state_first else i
    if p.state_first:                      # the state blocks take 0..ns-1
        assert (b[:ns] >= p.y_blocks).all()
    yb, sb = b[b < p.y_blocks], b[b >= p.y_blocks] - p.y_blocks
    per = BN * H
    tile = p.qtiles - 1 - yb // per
    h, bc = (yb % per) % H, (yb % per) // H
    ycount = np.zeros((p.qtiles, H, BN), np.int32)
    np.add.at(ycount, (tile, h, bc), 1)
    assert (ycount == 1).all()
    assert (np.diff(tile) <= 0).all()              # heaviest tiles first
    sl_w, n_sl = ssd_ops.SLICE, -(-N // ssd_ops.SLICE)
    sl, rest = sb % p.slices, sb // p.slices
    h, bc = rest % H, rest // H
    scount = np.zeros((BN, H, P, N), np.int32)
    for k in range(len(sb)):
        p0, n0 = (sl[k] // n_sl) * sl_w, (sl[k] % n_sl) * sl_w
        scount[bc[k], h[k], p0:p0 + sl_w, n0:n0 + sl_w] += 1
    assert (scount == 1).all()


@pytest.mark.parametrize("N,ksteps", [(1, 4), (16, 4), (20, 4), (64, 4),
                                      (65, 8), (128, 8), (129, 16), (256, 16)])
def test_plan_ssd_takes_the_smallest_instantiation_that_holds_n(N, ksteps):
    assert ssd_ops.plan_ssd(1, 64, 2, N, 64, 2, True).ksteps == ksteps
    assert ssd_ops.plan_ssd(1, 64, 2, N, 64, 4, True).ksteps == 0


@pytest.mark.parametrize("esize,N,P,aligned,vec", [
    (2, 128, 64, True, True), (2, 20, 64, True, False),
    (2, 128, 24, True, True), (2, 128, 12, True, False),
    (2, 128, 64, False, False), (4, 20, 24, True, True),
    (4, 18, 24, True, False), (4, 128, 64, False, False)])
def test_plan_ssd_copies_16_bytes_only_where_rows_stay_aligned(esize, N, P,
                                                               aligned, vec):
    assert ssd_ops.plan_ssd(2, 100, 3, N, P, esize, aligned).vec is vec


# ---------------------------------------------------------------------------
# plan_conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,esize", [(1794, 2), (130, 2), (130, 4), (6, 4)])
def test_plan_conv_scalar_where_c_is_not_a_vector_multiple(C, esize):
    p = conv_ops.plan_conv(1, 64, C, esize, True)
    assert not p.vector and p.width == 1


@pytest.mark.parametrize("dtype,offset,vector", [
    (torch.bfloat16, 1, False), (torch.bfloat16, 3, False),
    (torch.bfloat16, 8, True), (torch.float32, 1, False),
    (torch.float32, 4, True)])
def test_plan_conv_scalar_for_a_view_off_16_byte_alignment(dtype, offset,
                                                           vector):
    """A contiguous view at a storage offset (the model's ``.contiguous()``
    of a slice that already is contiguous) is legal input; it takes the
    scalar path unless its offset keeps 16-byte alignment."""
    B, S, C = 1, 128, 1792
    base = torch.zeros(offset + B * S * C, dtype=dtype)
    x = base[offset:].view(B, S, C)
    assert x.is_contiguous() and x.storage_offset() == offset
    p = conv_ops.plan_conv(B, S, C, x.element_size(), x.data_ptr() % 16 == 0)
    assert p.vector is vector
    assert p.width == (16 // x.element_size() if vector else 1)


@pytest.mark.parametrize("B,C", [(1, 1792), (4, 1792), (64, 8192)])
def test_plan_conv_runs_one_step_a_thread_at_decode(B, C):
    p = conv_ops.plan_conv(B, 1, C, 2, True)
    assert p.run == 1 and p.runs == 1
    # a launch short of one block of channel vectors an SM goes one
    # channel a thread
    assert p.vector is (B * C // 8 >= 132 * conv_ops.THREADS)


@pytest.mark.parametrize("B,S,C,vector", [
    (4, 1, 1792, False), (4, 4, 2560, False), (1, 128, 1792, True),
    (1, 512, 1792, True), (1, 75, 1792, False), (1, 76, 1792, True)])
def test_plan_conv_vectors_only_launches_that_fill_the_card(B, S, C, vector):
    assert conv_ops.plan_conv(B, S, C, 2, True).vector is vector


@pytest.mark.parametrize("B,S,C,esize,aligned", [
    (1, 512, 1792, 2, True),           # mamba2-130m prefill layer
    (1, 2560, 2560, 2, True),          # recurrentgemma-2b prefill layer
    (4, 1, 1792, 2, True),             # decode step
    (2, 3000, 200, 2, True),           # long S
    (3, 2, 130, 4, True),              # S < K-1, scalar
    (2, 37, 1794, 2, False),           # unaligned
    (8, 4096, 2048, 2, True),          # long runs
])
def test_plan_conv_grid_covers_every_item_once(B, S, C, esize, aligned):
    p = conv_ops.plan_conv(B, S, C, esize, aligned)
    cols = C // p.width
    assert p.runs * p.run >= S > (p.runs - 1) * p.run
    i = np.arange(p.blocks * conv_ops.THREADS, dtype=np.int64)
    i = i[i < B * p.runs * cols]
    assert len(i) > (p.blocks - 1) * conv_ops.THREADS   # the last block is used
    cv, rest = i % cols, i // cols
    run, b = rest % p.runs, rest // p.runs
    count = np.zeros((B, S, cols), np.int32)
    for step in range(p.run):
        t = run * p.run + step
        ok = t < S
        np.add.at(count, (b[ok], t[ok], cv[ok]), 1)
    assert (count == 1).all()
    # one thread a (b, channel group) ends its run at step S-1 and writes
    # the new tail
    last = (run + 1) * p.run >= S
    tails = np.zeros((B, cols), np.int32)
    np.add.at(tails, (b[last], cv[last]), 1)
    assert (tails == 1).all()


def test_plan_conv_lengthens_runs_only_past_two_waves():
    small = conv_ops.plan_conv(1, 512, 1792, 2, True)
    big = conv_ops.plan_conv(1, 2560, 2560, 2, True)
    assert small.run == 1
    assert big.run > 1
    items = 1 * -(-2560 // big.run) * (2560 // 8)
    assert items >= 2 * 132 * conv_ops.RESIDENT


# ---------------------------------------------------------------------------
# plan_lstm
# ---------------------------------------------------------------------------
LSTM_SHAPES = [(23, 1, 128, 64), (23, 1, 64, 64), (1, 23, 128, 64),
               (3, 5, 48, 160), (2, 3, 4000, 64), (4, 2, 7, 50), (5, 3, 1, 64),
               (1, 1, 12 * 1024 - 64, 64), (2, 9, 6000, 6000), (1, 1, 1, 1)]


@pytest.mark.parametrize("R,B,D,H", LSTM_SHAPES)
def test_plan_lstm_covers_every_unit_and_row_once(R, B, D, H):
    p = lstm_ops.plan_lstm(R, B, D, H)
    K = D + H
    btiles, jtiles = -(-B // p.bt), -(-H // p.ju)
    assert p.blocks == R * btiles * jtiles
    blk = np.arange(p.blocks)
    jt, rest = blk % jtiles, blk // jtiles
    bti, r = rest % btiles, rest // btiles
    count = np.zeros((R, B, H), np.int32)
    for e in range(p.bt):
        for u in range(p.ju):
            b, j = bti * p.bt + e, jt * p.ju + u
            ok = (b < B) & (j < H)
            np.add.at(count, (r[ok], b[ok], j[ok]), 1)
    assert (count == 1).all()
    # the stages, and within each the warps' slices, take every row once
    slices = lstm_ops.THREADS // (4 * p.ju)
    rows = np.zeros(K, np.int32)
    for k0 in range(0, K, p.rows):
        n = min(p.rows, K - k0)
        for sl in range(slices):
            rows[k0 + np.arange(sl, n, slices)] += 1
    assert (rows == 1).all()
    assert p.stages == (1 if p.rows >= K else 2)


def test_plan_lstm_fills_the_card_at_the_forecast_shape():
    for D in (128, 64):
        p = lstm_ops.plan_lstm(23, 1, D, 64)
        assert p.blocks >= 132 and p.ju == 8 and p.bt == 1 and p.stages == 1
        assert p.vec16
    assert lstm_ops.plan_lstm(1, 23, 128, 64).blocks >= 132
    assert not lstm_ops.plan_lstm(4, 2, 7, 50).vec16        # H % 4 != 0
    assert not lstm_ops.plan_lstm(23, 1, 128, 64, aligned=False).vec16


@pytest.mark.parametrize("R,B,H", [(1, 1, 64), (23, 1, 64), (2, 64, 4),
                                   (1, 8, 1024), (3, 5, 160)])
@pytest.mark.parametrize("K", [2, 192, 4064, 8192, 12 * 1024])
def test_plan_lstm_fits_shared_memory_up_to_12k_rows(R, B, H, K):
    D = max(K - H, 1)
    p = lstm_ops.plan_lstm(R, B, D, H)
    assert p.smem <= SMEM_LIMIT
    assert p.stages * p.rows * 16 * p.ju <= lstm_ops.RING_BYTES


# ---------------------------------------------------------------------------
# The autograd Functions: the kernel forward, autograd through the plain
# version backward, taken down the CUDA route with a stand-in library that
# computes the plain version into the launch's output pointers
# ---------------------------------------------------------------------------
def _at(ptr, *shape):
    """The float32 tensor at ``ptr`` (an ``_OnCard`` tensor's CPU memory)."""
    import ctypes
    buf = (ctypes.c_float * int(np.prod(shape))).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(shape))


class _PlainLibrary:
    """Stands in for the Pix-Con and LSTM-step libraries: each launch reads
    its inputs at the packed pointers, computes the plain version there
    and writes it to the packed outputs."""

    def __init__(self):
        self.launches = 0

    def pixcon_gate_launch(self, packed):
        from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
        f = struct.unpack("=18qf", packed)
        R, B, T, P, F, Hp = f[8:14]
        ins = [_at(f[0], R, B, T, P), _at(f[1], R, B, P, F),
               _at(f[2], R, F, Hp), _at(f[3], R, Hp), _at(f[4], R, Hp),
               _at(f[5], R, 1)]
        out, w = pixcon_gate_ref(*ins, temperature=1.0 / float(f[18]),
                                 normalize=bool(f[14]))
        _at(f[6], R, B, T, P).copy_(out)
        _at(f[7], R, B, P).copy_(w)
        self.launches += 1
        return 0

    def lstm_cell_launch(self, packed):
        from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
        f = struct.unpack("21q", packed)
        R, B, D, H = f[8:12]
        ins = [_at(f[0], R, B, D), _at(f[1], R, B, H), _at(f[2], R, B, H),
               _at(f[3], R, D, 4, H), _at(f[4], R, H, 4, H), _at(f[5], R, 4, H)]
        h, c = lstm_cell_ref(*ins)
        _at(f[6], R, B, H).copy_(h)
        _at(f[7], R, B, H).copy_(c)
        self.launches += 1
        return 0


@pytest.fixture
def plain_library(monkeypatch):
    lib = _PlainLibrary()
    for ops in (pixcon_ops, lstm_ops):
        monkeypatch.setattr(ops, "_lib", lambda: lib)
        monkeypatch.setattr(ops, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(lstm_ops, "sm_count", lambda dev: 132)
    for fn in (pixcon_ops.pixcon_gate, lstm_ops.lstm_cell_fused):
        monkeypatch.setattr(fn, "launches", fn.launches)
    return lib


def _plain(t, grad=False):
    return t.as_subclass(torch.Tensor).detach().clone().requires_grad_(grad)


def _grads_through(fn, inputs, wanted, seed):
    """Outputs of ``fn(*inputs)`` and the gradients of a fixed random
    linear function of those that require one with respect to ``wanted``."""
    outs = fn(*inputs)
    g = torch.Generator().manual_seed(seed)
    loss = sum((o.as_subclass(torch.Tensor)
                * torch.randn(o.shape, generator=g)).sum()
               for o in outs if o.requires_grad)
    grads = torch.autograd.grad(loss, [inputs[i] for i in wanted])
    return outs, [gr.as_subclass(torch.Tensor) for gr in grads]


@pytest.mark.parametrize("normalize,temperature", [(True, 1.0), (False, 0.5)])
@pytest.mark.parametrize("wanted", [(2, 3, 4, 5), (0, 2, 3, 4, 5)])
def test_pixcon_function_gradients_are_autograd_through_plain(
        plain_library, normalize, temperature, wanted):
    """The gated output differentiated, ``w`` non-differentiable; data
    inputs (x, the features) get no gradient unless they ask for one."""
    from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
    a = _pixcon_inputs(R=2, B=3, T=5, P=8)
    names = ("x", "feats", "w1", "b1", "w2", "b2")
    card = [a[n].requires_grad_(i in wanted) for i, n in enumerate(names)]
    kw = dict(temperature=temperature, normalize=normalize)
    outs, grads = _grads_through(
        lambda *t: pixcon_ops.pixcon_gate(*t, **kw), card, wanted, seed=1)
    assert plain_library.launches == 1 and pixcon_ops.pixcon_gate.launches >= 1
    assert type(outs[0].grad_fn).__name__ == "PixconGateBackward"
    assert not outs[1].requires_grad

    def plain_gate(*t):
        out, w = pixcon_gate_ref(*t, **kw)
        return out, w.detach()
    plain = [_plain(a[n], i in wanted) for i, n in enumerate(names)]
    want_outs, want = _grads_through(plain_gate, plain, wanted, seed=1)
    for o, w in zip(outs, want_outs):
        assert torch.equal(o.as_subclass(torch.Tensor).detach(), w.detach())
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("wanted", [(0, 1, 2, 3, 4, 5), (3, 4, 5), (0, 3)])
def test_lstm_function_gradients_are_autograd_through_plain(plain_library,
                                                            wanted):
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
    a = _lstm_inputs(R=2, B=3, D=8, H=16)
    names = ("x", "h", "c", "wx", "wh", "b")
    card = [a[n].requires_grad_(i in wanted) for i, n in enumerate(names)]
    outs, grads = _grads_through(lstm_ops.lstm_cell_fused, card, wanted, seed=2)
    assert plain_library.launches == 1
    assert type(outs[0].grad_fn).__name__ == "LstmCellBackward"
    plain = [_plain(a[n], i in wanted) for i, n in enumerate(names)]
    want_outs, want = _grads_through(lstm_cell_ref, plain, wanted, seed=2)
    for o, w in zip(outs, want_outs):
        assert torch.equal(o.as_subclass(torch.Tensor).detach(), w.detach())
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "no_input_grad"])
def test_forecast_route_launches_directly(plain_library, monkeypatch, mode):
    """Without a gradient to take, a wrapper launches the kernel directly:
    the autograd Functions are never entered."""
    def no_function(*a):
        raise AssertionError("an autograd Function was entered")
    monkeypatch.setattr(pixcon_ops.PixconGate, "apply", no_function)
    monkeypatch.setattr(lstm_ops.LstmCell, "apply", no_function)
    p, s = _pixcon_inputs(), _lstm_inputs()
    if mode != "no_input_grad":
        for t in (p["w1"], s["wx"]):
            t.requires_grad_()
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "no_input_grad": torch.enable_grad}[mode]
    with ctx():
        out, w = pixcon_ops.pixcon_gate(**p)
        h, c = lstm_ops.lstm_cell_fused(**s)
    assert plain_library.launches == 2
    assert all(t.grad_fn is None and not t.requires_grad for t in (out, w, h, c))


def test_cpu_route_is_the_plain_version_under_autograd():
    """On CPU tensors the wrappers return the plain version, traced by
    autograd as usual, and launch nothing."""
    a = {k: _plain(v, k.startswith(("w", "b"))) for k, v in _lstm_inputs().items()}
    before = lstm_ops.lstm_cell_fused.launches
    h, _ = lstm_ops.lstm_cell_fused(**a)
    assert lstm_ops.lstm_cell_fused.launches == before
    assert h.grad_fn is not None and "LstmCell" not in type(h.grad_fn).__name__
