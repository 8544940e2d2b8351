"""AdamW with the JAX package's memory-plan options: the torch twin of
``repro.distributed.optimizer``.

Moments are stored per ``AdamWConfig.moment_dtype``:

* ``float32`` — standard AdamW (dense archs);
* ``int8``    — blockwise-quantized moments (block 128 along the trailing
  axis, absmax scaling), the 8-bit-Adam trick of the JAX package.

The state is the JAX package's tree, ``{"step", "m", "v"}`` with ``m`` and
``v`` shaped like the parameters and a quantized moment ``{"q", "scale"}``,
so its checkpoint leaves (``opt__m__...``) have the same names in both
packages and a checkpoint moves between them.

``apply_updates`` updates the parameters and the moments in place under
``torch.no_grad()`` (the JAX package returns new arrays): a model's cached
views of its parameters stay valid, and no second copy of the state is made.
Every update is computed in f32 and cast back to the parameter's dtype. A
layer-stacked leaf (leading layer axis) is updated one layer at a time, so
the f32 temporaries are layer-sized, as the JAX package's ``lax.scan`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

BLOCK = 128


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # 'float32' | 'int8'
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ------------------------------------------------------------- quantization
def quantize_blockwise(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """int8 absmax quantization over trailing-axis blocks of 128 (the last
    axis zero-padded to a multiple of 128)."""
    x = x.to(torch.float32)
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    blocks = x.reshape(*x.shape[:-1], -1, BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale[..., 0]}


def dequantize_blockwise(d: Dict[str, torch.Tensor], n: int) -> torch.Tensor:
    q = d["q"].to(torch.float32)
    blocks = q.reshape(*q.shape[:-1], -1, BLOCK) * d["scale"][..., None]
    return blocks.reshape(q.shape)[..., :n]


# ------------------------------------------------------------------- state
def _quantizable(p: torch.Tensor) -> bool:
    """Blockwise int8 pays off only for real tensors (scalars and tiny
    vectors keep f32 moments)."""
    return p.dim() >= 1 and p.numel() >= BLOCK


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (the first
    tree's); a leaf of a later tree may itself be a dict (a quantized
    moment)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree: Any) -> list:
    """The tensors of nested dicts in the JAX pytree order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def init_state(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments on each parameter's device, and step 0."""
    def zero_moment(p: torch.Tensor):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.moment_dtype == "int8" and _quantizable(p):
            return quantize_blockwise(z)
        return z

    device = leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zero_moment, params),
        "v": tree_map(zero_moment, params),
    }


def _lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (f32, as the JAX
    package computes it)."""
    s = step.to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    t = torch.clamp((s - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)))


def _stacked(p: torch.Tensor) -> bool:
    """A layer-stacked leaf worth updating a layer at a time."""
    return p.dim() >= 3 and p.shape[0] <= 128 and p.numel() // p.shape[0] >= (1 << 20)


def _store_moment(dst, value: torch.Tensor) -> None:
    if isinstance(dst, dict):
        q = quantize_blockwise(value)
        dst["q"].copy_(q["q"])
        dst["scale"].copy_(q["scale"])
    else:
        dst.copy_(value)


def _update(p, g, m, v, clip, lr, b1c, b2c, cfg: AdamWConfig) -> None:
    """One leaf's AdamW update, written into ``p``, ``m`` and ``v``."""
    g = g.to(torch.float32) * clip
    n = p.shape[-1] if p.dim() else 1
    m_f = dequantize_blockwise(m, n) if isinstance(m, dict) else m
    v_f = dequantize_blockwise(v, n) if isinstance(v, dict) else v
    m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
    v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
    u = (m_f / b1c) / (torch.sqrt(v_f / b2c) + cfg.eps)
    if cfg.weight_decay and p.dim() >= 2:  # decay matrices only
        u = u + cfg.weight_decay * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
    _store_moment(m, m_f)
    _store_moment(v, v_f)


def _layer(moment, i: int):
    if isinstance(moment, dict):
        return {k: t[i] for k, t in moment.items()}
    return moment[i]


@torch.no_grad()
def apply_updates(
    params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step over nested dicts of parameters and their gradients.
    Parameters and moments are updated in place and returned with the state
    (its ``step`` advanced) and ``{"lr", "grad_norm"}`` as 0-d tensors."""
    step = state["step"] + 1
    lr = _lr_at(step, cfg)
    gnorm = global_norm(grads)
    clip = (torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
            if cfg.grad_clip else 1.0)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step.to(torch.float32))
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step.to(torch.float32))

    def upd(p, g, m, v):
        if _stacked(p):
            for i in range(p.shape[0]):
                _update(p[i], g[i], _layer(m, i), _layer(v, i), clip, lr, b1c, b2c, cfg)
        else:
            _update(p, g, m, v, clip, lr, b1c, b2c, cfg)

    tree_map(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
