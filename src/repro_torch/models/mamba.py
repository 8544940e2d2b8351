"""Mamba2 (SSD, state-space duality) block: chunked prefill scan and O(1) decode.

The torch twin of the JAX package's ``models/mamba.py`` for training and
serving, with the same parameters and arithmetic. The recurrence::

    h_t = exp(dt_t · A_h) · h_{t-1} + B_t ⊗ (dt_t · x_t)
    y_t = C_t · h_t + D_h · x_t

The prefill runs it in its chunked dual form through ``ops.ssd_scan`` (the
hand-written CUDA kernel on the card, its plain version on the CPU), which
computes in f32 and returns the f32 final state; the JAX package's
``ssd_chunked`` computes the same form with einsums in the activations'
dtype. Under autograd the scan records its backward (the hand-written
backward kernel on the card, the plain scan's autograd on the CPU); the
final state has none, so ``return_state`` under grad raises. Decode is a constant-time state update in plain PyTorch ops, as in
the JAX package, and writes the cache in place without a host sync.

The input projection is split into ``w_z``/``w_x``/``w_B``/``w_C``/``w_dt``
as in the JAX package (n_groups 1), so checkpoints move between the two.

Serving computes on a rank's blocks of the layer (``sp``,
``distributed/tensor_parallel.py``; the whole weights under ``tp.ONE``), as
the reference's ``partition.param_specs`` stores them over ``model``:
``w_z``, ``w_x``, ``w_dt``, ``conv_x_*`` and ``norm`` on the rank's
``d_inner`` channels and SSM heads, ``A_log``/``D``/``dt_bias`` whole and
sliced to those heads, ``w_B``/``w_C`` and their convolutions on ``G·N``
(depthwise, so a block convolves alone; B and C are then all-gathered,
since with one group every head reads all of N), the gated RMSNorm's mean
square summed over ``model`` from each block's share, ``out_proj`` row-parallel. The SSM state
and the conv windows of the cache hold the same blocks. A rank whose
``d_inner`` block does not hold whole heads, or whose ``w_dt`` holds other
heads than its ``w_x``, raises (ROADMAP.md item 18). Training computes on
whole weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tp
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
                chunk: int, return_state: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """u (B,L,H,P) already scaled by dt, dtA (B,L,H), Bm/Cm (B,L,N) ->
    (y (B,L,H,P) in u's dtype, final state (B,H,P,N) in f32, or None without
    ``return_state``), from a zero state. The model layout of the JAX
    package's ``ssd_chunked``, moved to the kernel's (B,H,L,P) and back."""
    got = ops.ssd_scan(u.transpose(1, 2).contiguous(), dtA.transpose(1, 2).contiguous(),
                       Bm.contiguous(), Cm.contiguous(), chunk=chunk, return_state=return_state)
    y, final = got if return_state else (got, None)
    return y.transpose(1, 2), final


def _rank_heads(p, cfg: ModelConfig, sp: tp.Split) -> Tuple[int, int]:
    """(the first of this rank's SSM heads, their number) from its blocks of
    ``w_x`` (d, channels) and ``w_dt`` (d, heads), which must hold the same
    whole heads; every head where the weights are whole."""
    H, P = cfg.n_ssm_heads, cfg.ssm.headdim
    channels, heads = p["w_x"].shape[1], p["w_dt"].shape[1]
    if channels != heads * P:
        raise ValueError(
            f"a rank's blocks w_x {tuple(p['w_x'].shape)} and w_dt {tuple(p['w_dt'].shape)} do "
            f"not hold the same whole SSM heads of {P} channels (d_inner {cfg.d_inner}, {H} "
            f"heads, model {sp.model}): ROADMAP.md item 18")
    return tp.offset(heads, H, sp), heads


def _heads_of(t: torch.Tensor, h0: int, heads: int) -> torch.Tensor:
    """Heads ``[h0, h0 + heads)`` of a whole ``(H,)`` leaf (itself when whole)."""
    return t if t.shape[0] == heads else t[h0:h0 + heads]


def _whole_groups(t: torch.Tensor, cfg: ModelConfig, sp: tp.Split) -> torch.Tensor:
    """The convolved B or C (..., G·N) from this rank's block of its columns:
    all-gathered over ``model`` where the block is part of it."""
    if t.shape[-1] == cfg.ssm.n_groups * cfg.ssm.d_state:
        return t
    return tp.all_gather_for_split(t, sp, dim=-1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, cfg: ModelConfig,
                sp: tp.Split) -> torch.Tensor:
    """``rmsnorm(y · silu(z), w)`` over the whole ``d_inner`` from this
    rank's block of its channels: its share of the mean square summed over
    ``model``."""
    return rmsnorm(y * F.silu(z), w, sum_over=lambda t: tp.sum_over_model(t, sp),
                   width=cfg.d_inner)


def _out(p, y: torch.Tensor, cfg: ModelConfig, sp: tp.Split) -> torch.Tensor:
    """``out_proj`` of the normed ``y``: row-parallel, summed over ``model``,
    where the rank holds a block of its ``d_inner`` rows."""
    w = p["out_proj"]
    out = y @ w.to(y.dtype)
    return out if w.shape[0] == cfg.d_inner else tp.reduce_from_model(out, sp)


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False,
                  sp: tp.Split = tp.ONE):
    """Prefill pass over x (B,S,d). Returns (B,S,d), and with
    ``return_state`` also (final ssm state (B,H,P,N) f32, conv tails): the
    last ``conv_width - 1`` pre-conv inputs of each conv, for decode. On a
    rank's blocks (``sp``): its heads' state and its channels' tails."""
    s = cfg.ssm
    B, S, _ = x.shape
    h0, H = _rank_heads(p, cfg, sp)
    P = s.headdim
    z, xi, Bi, Ci, dt = _proj(p, x)
    xs = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"])
    Bm = _whole_groups(_causal_conv(Bi, p["conv_B_w"], p["conv_B_b"]), cfg, sp)
    Cm = _whole_groups(_causal_conv(Ci, p["conv_C_w"], p["conv_C_b"]), cfg, sp)
    dt = F.softplus(dt.float() + _heads_of(p["dt_bias"], h0, H).float())
    A = -torch.exp(_heads_of(p["A_log"], h0, H).float())  # (H,) negative
    dtA = dt * A  # (B,S,H)
    xh = xs.reshape(B, S, H, P)
    u = xh * dt[..., None].to(x.dtype)
    y, final = ssd_chunked(u, dtA, Bm, Cm, s.chunk, return_state=return_state)
    y = y + xh * _heads_of(p["D"], h0, H).to(x.dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(B, S, H * P), z, p["norm"], cfg, sp)
    out = _out(p, y, cfg, sp)
    if return_state:
        tail = slice(-(s.conv_width - 1), None)
        return out, (final, {"x": xi[:, tail], "B": Bi[:, tail], "C": Ci[:, tail]})
    return out


def mamba_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, sp: tp.Split = tp.ONE) -> torch.Tensor:
    """One step for x (B,1,d). ``cache`` holds this layer's ssm (B,H,P,N)
    and conv_{x,B,C} (B,W-1,·) tensors (a rank's blocks under ``sp``: its
    heads and channels), which are updated in place."""
    h0, H = _rank_heads(p, cfg, sp)
    P = cfg.ssm.headdim
    z, xi, Bi, Ci, dt = _proj(p, x)
    wins = {}
    for key, new in (("conv_x", xi), ("conv_B", Bi), ("conv_C", Ci)):
        wins[key] = torch.cat([cache[key], new.to(cache[key].dtype)], dim=1)
    xs = _conv_step(wins["conv_x"].to(x.dtype), p["conv_x_w"], p["conv_x_b"])  # (B, di)
    Bm = _whole_groups(_conv_step(wins["conv_B"].to(x.dtype), p["conv_B_w"], p["conv_B_b"]),
                       cfg, sp)  # (B, N)
    Cm = _whole_groups(_conv_step(wins["conv_C"].to(x.dtype), p["conv_C_w"], p["conv_C_b"]),
                       cfg, sp)
    dt1 = F.softplus(dt[:, 0].float() + _heads_of(p["dt_bias"], h0, H).float())  # (B,H)
    A = -torch.exp(_heads_of(p["A_log"], h0, H).float())
    dec = torch.exp(dt1 * A).to(x.dtype)
    xh = xs.reshape(-1, H, P)
    u = xh * dt1[..., None].to(x.dtype)
    state = cache["ssm"].to(x.dtype) * dec[:, :, None, None] + u[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cm) + xh * _heads_of(p["D"], h0, H).to(
        x.dtype)[None, :, None]
    y = _gated_norm(y.reshape(-1, 1, H * P), z, p["norm"], cfg, sp)
    out = _out(p, y, cfg, sp)
    cache["ssm"].copy_(state)
    for key, win in wins.items():
        cache[key].copy_(win[:, 1:])
    return out


def empty_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device: Any, layers: int, p: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, torch.Tensor]:
    """Zeroed caches of ``layers`` layers, stacked on a leading axis; with
    ``p`` (a layer's ``ssm`` blocks on a rank), of its heads and channels."""
    s = cfg.ssm
    P, N, W = s.headdim, s.d_state, s.conv_width
    if p is None:
        H, di, GN = cfg.n_ssm_heads, cfg.d_inner, s.n_groups * N
    else:
        H, di, GN = p["w_dt"].shape[1], p["w_x"].shape[1], p["w_B"].shape[1]

    def zeros(*shape):
        return torch.zeros((layers, batch) + shape, dtype=dtype, device=device)

    return {
        "ssm": zeros(H, P, N),
        "conv_x": zeros(W - 1, di),
        "conv_B": zeros(W - 1, GN),
        "conv_C": zeros(W - 1, GN),
    }
