"""Configuration dataclasses for the port: a copy of what the Dom-ST, the
dense-decoder, the mixture-of-experts, the Mamba-2, the RecurrentGemma
and the front-end (VLM, audio) paths read of the reference's
``configs/base.py``.

``MoEConfig``, ``SSMConfig``, ``RGLRUConfig``, ``PixConConfig``,
``DomSTConfig``, ``ModelConfig``, ``TrainConfig`` and ``ShapeConfig``
(with ``INPUT_SHAPES``, the launch tooling's four input shapes) are
field-for-field copies, with the same defaults and the same helpers
(``d_inner``, ``num_heads``, ``padded_vocab``, ``resolved_head_dim``,
``layer_kinds``, ``supports_decode``, ``sub_quadratic``). Configs are
pure data and never touch a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

# Layer kinds understood by models/transformer.py
ATTN_GLOBAL = "global"          # full (causal or bidirectional) attention
ATTN_LOCAL = "local"            # sliding-window attention
RECURRENT = "recurrent"         # RG-LRU recurrent block (recurrentgemma)
SSM = "ssm"                     # Mamba-2 SSD block

LAYER_KINDS = (ATTN_GLOBAL, ATTN_LOCAL, RECURRENT, SSM)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (DeepSeekMoE / Qwen3-MoE style)."""

    num_experts: int                  # routed experts
    top_k: int                        # experts per token
    d_ff_expert: int                  # hidden dim of each routed expert
    num_shared: int = 0               # always-on shared experts
    d_ff_shared: int = 0              # hidden dim of shared expert(s); 0 -> d_ff_expert * num_shared
    aux_loss_coef: float = 0.01       # load-balance auxiliary loss
    capacity_factor: float = 1.25     # expert capacity slack (tokens dropped beyond)
    router_dtype: str = "float32"     # router math in fp32 for stability

    def __post_init__(self) -> None:
        if self.top_k > self.num_experts:
            raise ValueError(
                f"top_k={self.top_k} > num_experts={self.num_experts}")


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration [arXiv:2405.21060]."""

    state_dim: int = 128              # N: SSM state size per head
    head_dim: int = 64                # P: channels per SSD head
    expand: int = 2                   # d_inner = expand * d_model
    conv_width: int = 4               # causal depthwise conv kernel width
    chunk_size: int = 256             # SSD chunk length (dual form)
    ngroups: int = 1                  # B/C groups (GQA-analog for SSM)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block configuration (RecurrentGemma / Griffin)."""

    lru_width: int = 0                # 0 -> d_model (griffin uses ~4/3 d_model)
    conv_width: int = 4               # temporal conv in the recurrent block
    c_constant: float = 8.0           # the fixed `c` in a = exp(-c * softplus(Λ) * r)


@dataclass(frozen=True)
class PixConConfig:
    """Pix-Con: the paper's pixel-contribution block.

    ``num_partitions`` is the partitioning module's split of pixels by
    contribution score (paper Fig. 1b); partitions map onto the spatial
    block's heads.
    """

    prior_channels: int = 1           # domain prior channels (distance map)
    hidden: int = 32                  # contribution MLP hidden width
    num_partitions: int = 4           # dynamic pixel partitions (== spatial heads)
    normalize: bool = True            # normalize contribution weights over pixels
    temperature: float = 1.0


@dataclass(frozen=True)
class DomSTConfig:
    """The paper's Dom-ST model (Fig. 1): Pix-Con + spatial + temporal."""

    num_pixels: int = 64              # pixels per watershed grid (flattened)
    window_days: int = 30             # trailing days of precipitation (T)
    num_heads: int = 4                # parallel CNN heads (one per device in paper)
    cnn_channels: int = 32            # channels per head
    kernel_size: int = 3
    lstm_hidden: int = 64
    lstm_layers: int = 2              # stacked LSTM (paper: stacked layers)
    mlp_hidden: int = 64
    use_pixcon: bool = True
    use_target_day: bool = True       # the (+P) input
    pixcon: PixConConfig = field(default_factory=PixConConfig)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``family`` selects the top-level model builder:
      dense | moe | ssm | hybrid | encoder | vlm | audio | domst
    The port runs every family: ``vlm`` and ``audio`` use the same
    decoder/encoder stack but take precomputed patch/frame embeddings
    (front-end stubs).
    """

    name: str
    family: str
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0

    # stack details
    layer_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    window: int = 4096                # sliding window for ATTN_LOCAL
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"                 # silu | gelu
    qkv_bias: bool = False            # qwen2-style
    qk_norm: bool = False             # qwen3-style QK-RMSNorm
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    rope: bool = True
    logit_softcap: float = 0.0        # gemma2 final-logit softcap
    attn_softcap: float = 0.0         # gemma2 attention-logit softcap
    post_norms: bool = False          # gemma2 pre+post sandwich norms
    embed_scale: bool = False         # gemma-style sqrt(d_model) embed scaling
    causal: bool = True               # False for encoder-only (hubert)

    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    pixcon: Optional[PixConConfig] = None
    domst: Optional[DomSTConfig] = None
    first_k_dense: int = 0            # deepseek-moe: first k layers use dense FFN

    # modality frontends (stubs that provide embeddings)
    frontend: Optional[str] = None    # None | "audio_stub" | "vision_stub"
    frontend_dim: int = 0             # raw embedding dim fed by the stub
    num_patches: int = 0              # vlm: image patch tokens per example

    # optional generalized contribution gate (paper technique on LM archs)
    contribution_gate: bool = False

    tp_mode: str = "heads"            # sharding preference of the reference

    source: str = ""                  # citation (arXiv / hf card)
    notes: str = ""

    def padded_vocab(self, multiple: int = 128) -> int:
        """Vocab rounded up to ``multiple`` (the reference pads it so the
        embedding shards); padded logit columns are masked in unembed."""
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind list, pattern repeated/truncated to num_layers."""
        pat = self.layer_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    def supports_decode(self) -> bool:
        return self.causal and self.family not in ("encoder", "audio", "domst")

    def sub_quadratic(self) -> bool:
        """True if no layer needs a full-context KV cache (long_500k gate)."""
        kinds = set(self.layer_kinds())
        return ATTN_GLOBAL not in kinds

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """The reference's ``TrainConfig`` less what the port does not read
    (the compute and param dtypes: the port keeps float32 params and
    moments)."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # cosine | linear | constant
    grad_clip: float = 1.0
    optimizer: str = "adamw"          # adamw | sgd
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    remat: str = "none"               # none | block | full
    grad_accum: int = 1               # microbatches per step (activation memory / A)
    seed: int = 0
    fsdp: bool = False                # on a mesh: params and moments' embed over the data axes


@dataclass(frozen=True)
class ShapeConfig:
    """One of the 4 assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs as _pkg  # noqa: F401  (registers the variants)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> Sequence[str]:
    import repro_torch.configs as _pkg  # noqa: F401
    return sorted(_REGISTRY)
