"""HuBERT X-Large — audio encoder backbone [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means codebook units),
encoder-only (bidirectional). The conv waveform feature extractor is a
stub: batches bring precomputed 512-dim frame embeddings, and the model
owns the frame projection, the transformer and the unit-prediction head.
It has no decode step. A copy of the reference's
``configs/hubert_xlarge.py``.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig, register


@register("hubert-xlarge")
def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        layer_pattern=(ATTN_GLOBAL,),
        norm="layernorm",
        act="gelu",
        qkv_bias=True,            # fairseq MHA uses biases
        rope=False,               # HuBERT uses conv pos-emb; stubbed as learned-abs
        causal=False,
        tie_embeddings=False,
        frontend="audio_stub",
        frontend_dim=512,         # conv feature extractor output dim (stub)
        tp_mode="heads",          # 16 heads / 16-way model axis
        source="arXiv:2106.07447",
        notes="encoder-only; masked unit prediction objective",
    )
