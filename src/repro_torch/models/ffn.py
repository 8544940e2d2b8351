"""Dense (gated) MLP blocks: the JAX package's ``models/ffn.py`` as plain
matmuls."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .common import Initializer, activation
from .config import ModelConfig


def init_mlp(ini: Initializer, cfg: ModelConfig, d_ff: int = 0) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": ini.fanin((d, ff)), "w_down": ini.fanin((ff, d))}
    if cfg.mlp_gated:
        p["w_gate"] = ini.fanin((d, ff))
    return p


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.mlp_act)
    up = x @ p["w_up"].to(x.dtype)
    h = act(x @ p["w_gate"].to(x.dtype)) * up if cfg.mlp_gated else act(up)
    return h @ p["w_down"].to(x.dtype)
