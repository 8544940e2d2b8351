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

MLA (DeepSeek-V3; ``models/attention.py:222-327`` of the JAX package):
``mla_prefill`` (and ``mla_attention``, its training twin without the
cache, under autograd) runs the expanded form, q and k 128 + 64 wide (the no-RoPE
part and the RoPE part, k's RoPE part shared by all heads) and v 128 wide,
through ``ops.flash_attention`` at (192, 128) (k's RoPE part is expanded
over the heads, so its gradient sums over them); ``mla_decode`` the absorbed
form, in the latent space: q_lat = q_nope·W^kv_b's k part, concatenated with
q_rope (576 wide), attends the cache rows latent ++ k_rope with
``ops.decode_attention``, V being each row's latent (the first 512 columns),
at scale 192^-1/2; then W^kv_b's v part and ``wo``. RoPE rotates only the
64-wide parts, so its table is at ``qk_rope_head_dim``. The cache holds one
(B, S, kv_lora + rope) tensor a layer whose columns are the reference's
``latent`` and ``k_rope``.
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


# ----------------------------------------------------------------- MLA
def init_mla(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": ini.fanin((d, m.q_lora_rank)),
        "q_norm": ini.zeros((m.q_lora_rank,)),
        "wq_b": ini.fanin((m.q_lora_rank, H, qk)),
        "wkv_a": ini.fanin((d, m.kv_lora_rank + m.qk_rope_head_dim)),
        "kv_norm": ini.zeros((m.kv_lora_rank,)),
        "wkv_b": ini.fanin((m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)),
        "wo": ini.fanin((H, m.v_head_dim, d)),
    }


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions, freqs):
    """q_nope (B,H,S,nope), q_rope (B,H,S,rope), latent (B,S,r), k_rope
    (B,1,S,rope); ``freqs`` at the RoPE width."""
    m = cfg.mla
    q = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"])
    q_nope, q_rope = _heads(q, p["wq_b"]).split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, freqs)
    latent, k_rope = (x @ p["wkv_a"].to(x.dtype)).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    latent = rmsnorm(latent, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, None], positions, freqs)
    return q_nope, q_rope, latent, k_rope


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                freqs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA over the whole sequence of ``x`` (B,S,d), the expanded
    form. Returns the output (B,S,d) and the layer's cache columns: latent
    (B,S,r) and k_rope (B,S,rope)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, positions, freqs)
    k_nope, v = _heads(latent, p["wkv_b"]).split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, k_rope.expand(B, H, S, m.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = ops.flash_attention(q, k, v.contiguous(), causal=True)  # scale (nope + rope)^-1/2
    return _out_proj(o, p["wo"]), latent, k_rope[:, 0]


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                  freqs: torch.Tensor) -> torch.Tensor:
    """Training MLA over the whole sequence of ``x`` (B,S,d), the twin of
    the JAX package's ``mla_attention``: the expanded form of
    ``mla_prefill``, causal, without the cache. Differentiable; returns
    (B,S,d)."""
    return mla_prefill(p, x, cfg, positions=positions, freqs=freqs)[0]


def mla_decode(p, x: torch.Tensor, kv_cache: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig, *, freqs: torch.Tensor) -> torch.Tensor:
    """One absorbed-MLA decode step for ``x`` (B,1,d) at ``pos`` (a 0-d int32
    device tensor). Writes this step's latent ++ k_rope into row ``pos`` of
    ``kv_cache`` (B,S,r+rope) in place and returns the output (B,1,d)."""
    m = cfg.mla
    B = x.shape[0]
    H, r, nope = cfg.n_heads, m.kv_lora_rank, m.qk_nope_head_dim
    at = pos.reshape(1).long()
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, at, freqs)
    kv_cache.index_copy_(1, at, torch.cat([latent, k_rope[:, 0]], -1).to(kv_cache.dtype))
    wkv_b = p["wkv_b"].to(x.dtype)  # (r, H, nope + v)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, :, 0], wkv_b[:, :, :nope])
    q = torch.cat([q_lat, q_rope[:, :, 0]], -1).contiguous()  # (B, H, r + rope)
    rows = kv_cache[:, None]  # one cache head (B, 1, S, r + rope); V is its latent
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ctx = ops.decode_attention(q, rows, rows[..., :r], pos, scale=scale)  # (B, H, r)
    out = torch.einsum("bhr,rhv->bhv", ctx, wkv_b[:, :, nope:])
    return out.reshape(B, 1, -1) @ p["wo"].reshape(H * m.v_head_dim, -1).to(x.dtype)
