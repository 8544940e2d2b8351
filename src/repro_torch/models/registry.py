"""Family -> model class dispatch. The port serves the dense family; every
other family raises ``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

from typing import Any

from .config import ModelConfig


def build_model(cfg: ModelConfig, *, device: Any = None, seed: int = 0):
    """The model for ``cfg`` on ``device`` (default: the current CUDA device;
    raises without one unless ``device`` is given), random weights from
    ``seed``."""
    from .transformer import TransformerLM

    return TransformerLM(cfg, device=device, seed=seed)
