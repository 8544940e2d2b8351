"""Dense (gated) MLP blocks: the JAX package's ``models/ffn.py`` as plain
matmuls, on a rank's blocks of the weights in a serve or train step over a
mesh (``distributed/tensor_parallel.py``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..distributed import tensor_parallel as tp
from .common import Initializer, activation
from .config import ModelConfig


def init_mlp(ini: Initializer, cfg: ModelConfig, d_ff: int = 0) -> Dict[str, Any]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_up": ini.fanin((d, ff)), "w_down": ini.fanin((ff, d))}
    if cfg.mlp_gated:
        p["w_gate"] = ini.fanin((d, ff))
    return p


def mlp(p, x: torch.Tensor, cfg: ModelConfig, sp: tp.Split = tp.ONE) -> torch.Tensor:
    """The block on this rank's blocks (``sp``): ``w_up``/``w_gate``
    column-parallel on ``d_ff`` (entered through Megatron's ``f``),
    ``w_down`` row-parallel and summed over ``model`` (``g``); whole weights
    give the whole output."""
    act = activation(cfg.mlp_act)
    split = p["w_down"].shape[0] != cfg.d_ff
    if split:
        x = tp.copy_to_model(x, sp)
    up = x @ p["w_up"].to(x.dtype)
    h = act(x @ p["w_gate"].to(x.dtype)) * up if cfg.mlp_gated else act(up)
    y = h @ p["w_down"].to(x.dtype)
    return tp.reduce_from_model(y, sp) if split else y
