"""Family -> model class dispatch. The port serves and trains every family
of the JAX package: dense, vlm, moe, ssm, hybrid and encdec."""

from __future__ import annotations

from typing import Any

from .config import ModelConfig


def build_model(cfg: ModelConfig, *, device: Any = None, seed: int = 0):
    """The model for ``cfg`` on ``device`` (default: the current CUDA device;
    raises without one unless ``device`` is given), random weights from
    ``seed``."""
    from .ssm_lm import Mamba2LM, Zamba2LM
    from .transformer import TransformerLM
    from .whisper import WhisperModel

    cls = {"ssm": Mamba2LM, "hybrid": Zamba2LM, "encdec": WhisperModel}.get(
        cfg.family, TransformerLM)
    return cls(cfg, device=device, seed=seed)
