"""The host side of the conv1d, LSTM-step, Pix-Con and SSD-chunk
wrappers, on the CPU: their input checks, the launch plans they pass to
``csrc/conv1d.cu``, ``csrc/lstm_cell.cu`` and ``csrc/ssd_chunk.cu``
(``plan_conv``, ``plan_lstm``, ``plan_ssd``), and the arguments they pack
for a launch. No card is needed: a CPU tensor that reports a
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
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
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
            pixcon_ops: _Library("=18qf"), ssd_ops: _Library("21q")}
    for fn in (conv_ops.causal_conv1d, lstm_ops.lstm_cell_fused,
               pixcon_ops.pixcon_gate, ssd_ops.ssd_chunk_fused):
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
