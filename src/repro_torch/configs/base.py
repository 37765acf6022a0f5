"""Configuration dataclasses for the port: the Dom-ST subset of the
reference's ``configs/base.py``.

``PixConConfig`` and ``DomSTConfig`` are field-for-field copies;
``ModelConfig`` keeps only the fields the Dom-ST family reads. Configs are
pure data and never touch a device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence


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
    """Architecture description, cut down to what the Dom-ST family uses."""

    name: str
    family: str
    causal: bool = True
    domst: Optional[DomSTConfig] = None
    source: str = ""                  # citation

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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
