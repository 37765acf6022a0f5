"""Dom-ST — the paper's domain-aware distributed spatiotemporal network.

Pix-Con block + multihead multichannel 1D-CNN spatial block + stacked-LSTM
temporal block with target-day precipitation (+P) injection (Fig. 1).
"""
from repro_torch.configs.base import (
    DomSTConfig, ModelConfig, PixConConfig, register,
)


@register("domst")
def config() -> ModelConfig:
    return ModelConfig(
        name="domst",
        family="domst",
        causal=False,
        domst=DomSTConfig(
            num_pixels=64,
            window_days=30,
            num_heads=4,
            cnn_channels=32,
            kernel_size=3,
            lstm_hidden=64,
            lstm_layers=2,
            mlp_hidden=64,
            use_pixcon=True,
            use_target_day=True,
            pixcon=PixConConfig(num_partitions=4),
        ),
        source="Sarkar, Lu, Jannesari 2023 (this paper)",
    )


@register("domst-singlehead")
def config_singlehead() -> ModelConfig:
    """Paper baseline: single-head CNN, no Pix-Con, no (+P)."""
    base = config()
    return base.replace(
        name="domst-singlehead",
        domst=DomSTConfig(
            num_pixels=64, window_days=30, num_heads=1, cnn_channels=32,
            kernel_size=3, lstm_hidden=64, lstm_layers=2, mlp_hidden=64,
            use_pixcon=False, use_target_day=False,
        ),
    )


@register("domst-singlehead-p")
def config_singlehead_p() -> ModelConfig:
    """Paper baseline: Singlehead(+P) — adds target-day precipitation."""
    base = config()
    return base.replace(
        name="domst-singlehead-p",
        domst=DomSTConfig(
            num_pixels=64, window_days=30, num_heads=1, cnn_channels=32,
            kernel_size=3, lstm_hidden=64, lstm_layers=2, mlp_hidden=64,
            use_pixcon=False, use_target_day=True,
        ),
    )
