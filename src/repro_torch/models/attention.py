"""GQA attention: training, prefill / full-sequence and KV-cache decode.

The torch twin of the GQA half of the JAX package's ``models/attention.py``.
The JAX package computes prefill attention as a chunked pure-JAX loop — its
own reference for the Pallas flash kernel — and decode as one masked einsum.
Here the two are the package's kernels: ``ops.flash_attention`` (causal,
start-aligned, with the window on local layers) and ``ops.decode_attention``
(rows ``<= pos`` of the cache live). Both compute in f32 and return the
activations' dtype. Training (``gqa_attention``) runs the same flash kernel
under autograd; its backward is a kernel too.

Decode writes the new K/V row into the cache at ``pos`` in place
(``index_copy_``; the JAX package returns an updated copy), and ``pos`` is
a device tensor throughout, so a decode step issues no host sync.

MLA (``models/attention.py:222-327`` of the JAX package) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..kernels import ops
from .common import Initializer, apply_rope, rmsnorm
from .config import ModelConfig


def init_gqa(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Hp = H + cfg.head_pad
    wq = ini.fanin((d, Hp, hd))
    wo = ini.fanin((Hp, hd, d))
    if cfg.head_pad:
        # padded heads are exact zeros: they add nothing to the output
        wq[:, H:, :] = 0
        wo[H:, :, :] = 0
    p: Dict[str, Any] = {
        "wq": wq,
        "wk": ini.fanin((d, KV, hd)),
        "wv": ini.fanin((d, KV, hd)),
        "wo": wo,
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((Hp, hd))
        p["bk"] = ini.zeros((KV, hd))
        p["bv"] = ini.zeros((KV, hd))
    if cfg.qk_norm:
        p["q_norm"] = ini.zeros((hd,))
        p["k_norm"] = ini.zeros((hd,))
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) @ (d,h,k) -> (B,h,S,k)."""
    B, S, _ = x.shape
    h, k = w.shape[1], w.shape[2]
    return (x @ w.reshape(w.shape[0], h * k).to(x.dtype)).view(B, S, h, k).transpose(1, 2)


def _project_qkv(p, x, cfg: ModelConfig, positions, freqs):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,H,S,hd) @ (H,hd,d) -> (B,S,d)."""
    B, H, S, hd = o.shape
    return o.transpose(1, 2).reshape(B, S, H * hd) @ wo.reshape(H * hd, -1).to(o.dtype)


def gqa_attention(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                  window: int, freqs: torch.Tensor) -> torch.Tensor:
    """Training attention over the whole sequence of ``x`` (B,S,d), the
    twin of the JAX package's ``gqa_attention``: causal, ``window`` on local
    layers (0 on global ones). Differentiable; returns (B,S,d)."""
    q, k, v = _project_qkv(p, x, cfg, positions, freqs)
    return _out_proj(ops.flash_attention(q, k, v, causal=True, window=window), p["wo"])


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                window: int, freqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over the whole sequence of ``x`` (B,S,d). ``window``
    is the layer's sliding window (0 on global layers). Returns the output
    (B,S,d) and the layer's K and V (B,KV,S,hd) for the cache."""
    q, k, v = _project_qkv(p, x, cfg, positions, freqs)
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    return _out_proj(o, p["wo"]), k, v


def gqa_decode(p, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor, cfg: ModelConfig, *, window: int,
               freqs: torch.Tensor) -> torch.Tensor:
    """One decode step for ``x`` (B,1,d) at position ``pos`` (a 0-d int32
    device tensor). Writes this step's K/V into row ``pos`` of the caches
    (B,KV,S,hd) in place and returns the output (B,1,d)."""
    B = x.shape[0]
    at = pos.reshape(1).long()
    q, k_new, v_new = _project_qkv(p, x, cfg, at, freqs)
    k_cache.index_copy_(2, at, k_new.to(k_cache.dtype))
    v_cache.index_copy_(2, at, v_new.to(v_cache.dtype))
    H, hd = q.shape[1], q.shape[3]
    o = ops.decode_attention(q.view(B, H, hd), k_cache, v_cache, pos, window=window)
    return _out_proj(o.view(B, H, 1, hd), p["wo"])
