"""Mamba2 (SSD, state-space duality) block: chunked prefill scan and O(1) decode.

The torch twin of the JAX package's ``models/mamba.py`` for serving, with
the same parameters and arithmetic. The recurrence::

    h_t = exp(dt_t · A_h) · h_{t-1} + B_t ⊗ (dt_t · x_t)
    y_t = C_t · h_t + D_h · x_t

The prefill runs it in its chunked dual form through ``ops.ssd_scan`` (the
hand-written CUDA kernel on the card, its plain version on the CPU), which
computes in f32 and returns the f32 final state; the JAX package's
``ssd_chunked`` computes the same form with einsums in the activations'
dtype. Decode is a constant-time state update in plain PyTorch ops, as in
the JAX package, and writes the cache in place without a host sync.

The input projection is split into ``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``
as in the JAX package (n_groups 1), so checkpoints move between the two.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import Initializer, rmsnorm
from .config import ModelConfig


def init_mamba(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d, di = cfg.d_model, cfg.d_inner
    H = cfg.n_ssm_heads
    GN, W = s.n_groups * s.d_state, s.conv_width
    return {
        "w_z": ini.fanin((d, di)),
        "w_x": ini.fanin((d, di)),
        "w_B": ini.fanin((d, GN)),
        "w_C": ini.fanin((d, GN)),
        "w_dt": ini.fanin((d, H)),
        "conv_x_w": ini.normal((di, W), scale=0.1),
        "conv_x_b": ini.zeros((di,)),
        "conv_B_w": ini.normal((GN, W), scale=0.1),
        "conv_B_b": ini.zeros((GN,)),
        "conv_C_w": ini.normal((GN, W), scale=0.1),
        "conv_C_b": ini.zeros((GN,)),
        "A_log": ini.value(torch.log(torch.linspace(1.0, 16.0, H))),
        "D": ini.ones((H,)),
        "dt_bias": ini.zeros((H,)),
        "norm": ini.zeros((di,)),
        "out_proj": ini.fanin((di, d)),
    }


def _proj(p, x: torch.Tensor):
    """Returns (z, x_in, B_in, C_in, dt), before the convolutions."""
    return tuple(x @ p[name].to(x.dtype) for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence. x (B,S,C), w (C,W)."""
    S, W = x.shape[1], w.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + S, :] * w[:, i].to(x.dtype)
    return F.silu(out + b.to(x.dtype))


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """window (B, W, C) -> (B, C): one causal-conv output."""
    out = torch.sum(window * w.t()[None].to(window.dtype), dim=1)
    return F.silu(out + b.to(window.dtype))


def ssd_chunked(u: torch.Tensor, dtA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B,L,H,P) already scaled by dt, dtA (B,L,H), Bm/Cm (B,L,N) ->
    (y (B,L,H,P) in u's dtype, final state (B,H,P,N) in f32), from a zero
    state. The model layout of the JAX package's ``ssd_chunked``, moved to
    the kernel's (B,H,L,P) and back."""
    y, final = ops.ssd_scan(u.transpose(1, 2).contiguous(), dtA.transpose(1, 2).contiguous(),
                            Bm.contiguous(), Cm.contiguous(), chunk=chunk, return_state=True)
    return y.transpose(1, 2), final


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """Prefill pass over x (B,S,d). Returns (B,S,d), and with
    ``return_state`` also (final ssm state (B,H,P,N) f32, conv tails): the
    last ``conv_width - 1`` pre-conv inputs of each conv, for decode."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, P = cfg.n_ssm_heads, s.headdim
    z, xi, Bi, Ci, dt = _proj(p, x)
    xs = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"])
    Bm = _causal_conv(Bi, p["conv_B_w"], p["conv_B_b"])
    Cm = _causal_conv(Ci, p["conv_C_w"], p["conv_C_b"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())  # (H,) negative
    dtA = dt * A  # (B,S,H)
    xh = xs.reshape(B, S, H, P)
    u = xh * dt[..., None].to(x.dtype)
    y, final = ssd_chunked(u, dtA, Bm, Cm, s.chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = rmsnorm(y.reshape(B, S, cfg.d_inner) * F.silu(z), p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        tail = slice(-(s.conv_width - 1), None)
        return out, (final, {"x": xi[:, tail], "B": Bi[:, tail], "C": Ci[:, tail]})
    return out


def mamba_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """One step for x (B,1,d). ``cache`` holds this layer's ssm (B,H,P,N)
    and conv_{x,B,C} (B,W-1,·) tensors, which are updated in place."""
    s = cfg.ssm
    H, P = cfg.n_ssm_heads, s.headdim
    z, xi, Bi, Ci, dt = _proj(p, x)
    wins = {}
    for key, new in (("conv_x", xi), ("conv_B", Bi), ("conv_C", Ci)):
        wins[key] = torch.cat([cache[key], new.to(cache[key].dtype)], dim=1)
    xs = _conv_step(wins["conv_x"].to(x.dtype), p["conv_x_w"], p["conv_x_b"])  # (B, di)
    Bm = _conv_step(wins["conv_B"].to(x.dtype), p["conv_B_w"], p["conv_B_b"])  # (B, N)
    Cm = _conv_step(wins["conv_C"].to(x.dtype), p["conv_C_w"], p["conv_C_b"])
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["A_log"].float())
    dec = torch.exp(dt1 * A).to(x.dtype)
    xh = xs.reshape(-1, H, P)
    u = xh * dt1[..., None].to(x.dtype)
    state = cache["ssm"].to(x.dtype) * dec[:, :, None, None] + u[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cm) + xh * p["D"].to(x.dtype)[None, :, None]
    y = rmsnorm(y.reshape(-1, 1, cfg.d_inner) * F.silu(z), p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    cache["ssm"].copy_(state)
    for key, win in wins.items():
        cache[key].copy_(win[:, 1:])
    return out


def empty_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device: Any, layers: int) -> Dict[str, torch.Tensor]:
    """Zeroed caches of ``layers`` layers, stacked on a leading axis."""
    s = cfg.ssm
    H, P, N = cfg.n_ssm_heads, s.headdim, s.d_state
    GN, W = s.n_groups * N, s.conv_width

    def zeros(*shape):
        return torch.zeros((layers, batch) + shape, dtype=dtype, device=device)

    return {
        "ssm": zeros(H, P, N),
        "conv_x": zeros(W - 1, cfg.d_inner),
        "conv_B": zeros(W - 1, GN),
        "conv_C": zeros(W - 1, GN),
    }
