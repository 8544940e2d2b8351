"""Shared building blocks: init helpers, norms, RoPE, embeddings, the loss.

The torch twin of the JAX package's ``models/common.py``, with the same
arithmetic (norms and RoPE in f32 inside, the result in the input's dtype).
Parameters live in ``ParamTree`` modules whose nesting and names are the JAX
parameter pytree's, so a checkpoint leaf ``param__dense_layers__attn__wq``
is the parameter ``dense_layers.attn.wq`` here, with the same shape.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------------- params
class ParamTree(nn.Module):
    """A nested dict of parameters as a module: ``tree["attn"]["wq"]`` and
    ``tree.attn.wq`` are the same parameter, named ``attn.wq``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self) -> Dict[str, Any]:
        """The nested dict of tensors (the JAX package's params pytree)."""
        out: Dict[str, Any] = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


#: elements of the largest leaf drawn in one f32 call; above it (the MoE expert
#: leaves at full width: 384 × 7168 × 2048) a leaf is drawn a slice at a time,
#: so that its f32 draw never exists whole beside it. Smaller leaves keep the one
#: draw, so their values are unchanged.
_ONE_DRAW = 1 << 31


class Initializer:
    """Random parameters from an explicit ``torch.Generator``, at the JAX
    package's scales (``Initializer.normal``/``fanin``/``value``): drawn in f32 on
    ``device``, stored in ``dtype``. On the meta device nothing is drawn."""

    def __init__(self, device: torch.device, dtype: torch.dtype, seed: int):
        self.device = device
        self.dtype = dtype
        self.gen = None
        if device.type != "meta":
            self.gen = torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, scale: float = 0.02) -> torch.Tensor:
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        if math.prod(shape) <= _ONE_DRAW:
            x = torch.randn(shape, generator=self.gen, dtype=torch.float32, device=self.device)
            return (x * scale).to(self.dtype)
        # one draw a slice of the leading axis: no f32 copy of the whole leaf
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for part in out:
            part.copy_(torch.randn(part.shape, generator=self.gen, dtype=torch.float32,
                                   device=self.device) * scale)
        return out

    def fanin(self, shape) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return self.normal(shape, scale=1.0 / math.sqrt(fan_in))

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def value(self, val: torch.Tensor) -> torch.Tensor:
        """A given value (computed on the host), stored in ``dtype``."""
        if self.gen is None:
            return torch.empty(tuple(val.shape), dtype=self.dtype, device=self.device)
        return val.to(device=self.device, dtype=self.dtype)


def stack_init(n: int, init_fn: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    """Initialize ``n`` layers and stack each leaf on a leading axis, as the
    JAX package stacks its layers for ``lax.scan``. Each layer is copied into
    the stack as soon as it is made, so no more than one layer exists beside
    the stack; a stack of one layer is that layer (a view, no copy)."""
    def walk(fn, tree, *more):
        if isinstance(tree, dict):
            return {k: walk(fn, v, *(m[k] for m in more)) for k, v in tree.items()}
        return fn(tree, *more)

    first = init_fn()
    if n == 1:
        return walk(lambda t: t.unsqueeze(0), first)
    out = walk(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    walk(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        walk(lambda o, t: o[i].copy_(t), out, init_fn())
    return out


# --------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float = 1e-6,
            sum_over: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
            width: int = 0) -> torch.Tensor:
    """With ``sum_over`` and ``width``, the norm over a last dim of ``width``
    of which ``x`` may hold a block (a rank's): the block's f32 mean square,
    weighted by its share of ``width``, is summed by ``sum_over`` (over the
    ranks). A whole ``x`` takes its own mean, with no more launches."""
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    if sum_over is not None and x.shape[-1] != width:
        ms = sum_over(ms * (x.shape[-1] / width))
    y = x32 * torch.rsqrt(ms + eps)
    if weight is not None:
        y = y * (1.0 + weight.float())
    return y.to(x.dtype)


def layernorm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def make_norm(kind: str):
    """Return (init_fn(ini, d) -> params dict, apply_fn(params, x))."""
    if kind == "rmsnorm":
        return (lambda ini, d: {"scale": ini.zeros((d,))},
                lambda p, x: rmsnorm(x, p["scale"]))
    if kind == "layernorm":
        return (lambda ini, d: {"scale": ini.ones((d,)), "bias": ini.zeros((d,))},
                lambda p, x: layernorm(x, p["scale"], p["bias"]))
    if kind == "layernorm_np":  # olmo: non-parametric
        return (lambda ini, d: {}, lambda p, x: layernorm(x))
    raise ValueError(f"unknown norm {kind}")


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies. Made on ``device`` from host
    scalars only: no copy from the host, so a decode step stays sync-free."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., S, head_dim), positions: broadcastable to (..., S), freqs:
    ``rope_freqs(head_dim, theta)``; the half-split rotation of the JAX
    package, in f32."""
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- misc
def activation(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if kind == "silu":
        return F.silu
    if kind == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def cross_entropy_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) integer
    mask: Optional[torch.Tensor] = None,  # (B, S) 1.0 = count
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token NLL and accuracy over the masked positions, with the
    JAX package's explicit f32 max/sum reductions. As there, the max is
    detached inside the exp and not where it is added back, so the gradient
    is the JAX package's, which also carries the max's own (one-hot at the
    argmax) term (ROADMAP.md, faults; the fix is item 16)."""
    logits32 = logits.to(torch.float32)
    m = torch.max(logits32, dim=-1, keepdim=True).values
    sumexp = torch.sum(torch.exp(logits32 - m.detach()), dim=-1)
    lse = torch.log(sumexp) + m[..., 0]
    label_logit = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    mask = torch.ones_like(nll) if mask is None else mask.to(torch.float32)
    total = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll * mask) / total
    acc = torch.sum((torch.argmax(logits32, dim=-1) == labels) * mask) / total
    return loss, acc


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, scale: bool,
                 cdtype: torch.dtype) -> torch.Tensor:
    x = F.embedding(ids, table).to(cdtype)
    if scale:  # the factor is rounded to cdtype first, as in the JAX package
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=cdtype).item()
    return x
