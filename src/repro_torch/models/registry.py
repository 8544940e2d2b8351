"""Family -> model class dispatch. The port serves the dense, ssm and
hybrid families; every other family raises ``NotImplementedError`` naming
its ROADMAP item."""

from __future__ import annotations

from typing import Any

from .config import ModelConfig


def build_model(cfg: ModelConfig, *, device: Any = None, seed: int = 0):
    """The model for ``cfg`` on ``device`` (default: the current CUDA device;
    raises without one unless ``device`` is given), random weights from
    ``seed``."""
    from .ssm_lm import Mamba2LM, Zamba2LM
    from .transformer import TransformerLM

    cls = {"ssm": Mamba2LM, "hybrid": Zamba2LM}.get(cfg.family, TransformerLM)
    return cls(cfg, device=device, seed=seed)
