"""GQA attention: training, prefill / full-sequence and KV-cache decode.

The torch twin of the GQA half of the JAX package's ``models/attention.py``.
The JAX package computes prefill attention as a chunked pure-JAX loop — its
own reference for the Pallas flash kernel — and decode as one masked einsum.
Here the two are the package's kernels: ``ops.flash_attention`` (causal,
start-aligned, with the window on local layers) and ``ops.decode_attention``
(rows ``<= pos`` of the cache live). Both compute in f32 and return the
activations' dtype. Training (``gqa_attention``) runs the same flash kernel
under autograd; its backward is a kernel too.

Every GQA entry point computes on a rank's blocks of the layer's weights
(``sp``, ``distributed/tensor_parallel.py``), the whole weights under
``tp.ONE``. In training the split layer is Megatron's region: its input and
each whole leaf it uses enter through ``tp.copy_to_model`` (the gradient's
shares summed over ``model``), and ``wo``'s partial outputs leave through
``tp.reduce_from_model``.

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
``latent`` and ``k_rope``. In training, ``mla_attention`` computes on a
rank's blocks (``sp``): ``wq_a``'s and ``wkv_a``'s output columns
all-gathered before their norms, this rank's heads of ``wq_b`` and
``wkv_b`` through the flash kernel at (192, 128), ``wo`` row-parallel.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..distributed import tensor_parallel as tp
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


def _split_heads(x: torch.Tensor, w: torch.Tensor, b, n_heads: int, hd: int,
                 sp: tp.Split) -> Tuple[torch.Tensor, int]:
    """(B,h,S,hd) of the heads this rank's block of ``w`` (d, h, k) gives,
    with their bias, and the first one's index: a block split on heads gives
    its heads; one split on ``head_dim`` gives every head, its columns
    all-gathered (the activation, not the weight); a whole one every head."""
    t = _heads(x, w)
    if w.shape[2] != hd:  # every rank uses the heads its queries read: shares of the gradient
        t = tp.all_gather_for_split(t, sp, dim=3)
    off = tp.offset(t.shape[1], n_heads, sp)
    if b is not None:
        b_off = tp.offset(b.shape[0], n_heads, sp)
        t = t + b[off - b_off:off - b_off + t.shape[1]].to(x.dtype)[None, :, None, :]
    return t, off


def _project_qkv(p, x, cfg: ModelConfig, positions, freqs, sp: tp.Split = tp.ONE):
    """q, k, v (B,h,S,hd) of this rank's blocks (every head where the
    weights are whole), norms and RoPE on whole heads, and the index of q's
    first head and of k's and v's."""
    Hp, KV, hd = cfg.n_heads + cfg.head_pad, cfg.n_kv_heads, cfg.head_dim
    bias = cfg.qkv_bias
    q, q_off = _split_heads(x, p["wq"], p["bq"] if bias else None, Hp, hd, sp)
    k, kv_off = _split_heads(x, p["wk"], p["bk"] if bias else None, KV, hd, sp)
    v, _ = _split_heads(x, p["wv"], p["bv"] if bias else None, KV, hd, sp)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    return q.contiguous(), k.contiguous(), v.contiguous(), q_off, kv_off


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,H,S,hd) @ (H,hd,d) -> (B,S,d)."""
    B, H, S, hd = o.shape
    return o.transpose(1, 2).reshape(B, S, H * hd) @ wo.reshape(H * hd, -1).to(o.dtype)


def _out_split(o: torch.Tensor, o_off: int, wo: torch.Tensor, cfg: ModelConfig,
               sp: tp.Split) -> torch.Tensor:
    """``_out_proj`` on this rank's block of ``wo`` (h, k, d), for ``o``
    (B,h',S,hd) holding heads from ``o_off`` on: the block's heads, or its
    ``head_dim`` columns of every head, then the sum over ``model``; a whole
    ``wo`` gives the whole output."""
    Hp, hd = cfg.n_heads + cfg.head_pad, cfg.head_dim
    if wo.shape[0] != Hp:
        lo = tp.offset(wo.shape[0], Hp, sp) - o_off
        return tp.reduce_from_model(_out_proj(o[:, lo:lo + wo.shape[0]], wo), sp)
    if o.shape[1] != Hp:
        raise ValueError(f"a whole wo takes every head; have {o.shape[1]} of {Hp}")
    if wo.shape[1] != hd:
        lo = tp.offset(wo.shape[1], hd, sp)
        return tp.reduce_from_model(_out_proj(o[..., lo:lo + wo.shape[1]], wo), sp)
    return _out_proj(o, wo)


def _region(p, x: torch.Tensor, cfg: ModelConfig, sp: tp.Split):
    """The layer's input and weights as a training step over ``model`` uses
    them: where ``wo`` is split (the layer is a Megatron region), ``x`` and
    each leaf the rank holds whole through ``tp.copy_to_model``, since each
    rank's gradient of them is its heads' share; as they are elsewhere."""
    Hp, hd = cfg.n_heads + cfg.head_pad, cfg.head_dim
    if not sp.model_groups or tuple(p["wo"].shape[:2]) == (Hp, hd):
        return p, x
    heads = {"wq": Hp, "bq": Hp, "wk": cfg.n_kv_heads, "bk": cfg.n_kv_heads,
             "wv": cfg.n_kv_heads, "bv": cfg.n_kv_heads}

    def whole(name, w):  # (..., heads, hd) unsplit; QK-norm's (hd,) scales always
        return name in ("q_norm", "k_norm") or (name in heads and
                                                 tuple(w.shape[-2:]) == (heads[name], hd))

    return ({k: tp.copy_to_model(w, sp) if whole(k, w) else w for k, w in p.items()},
            tp.copy_to_model(x, sp))


def _kv_for(k: torch.Tensor, kv_off: int, q_off: int, nq: int, g: int) -> torch.Tensor:
    """The KV heads query heads ``[q_off, q_off + nq)`` read (group ``g``),
    from ``k``, which holds KV heads from ``kv_off`` on: whole groups as
    they are, a part of one group as its one KV head, else a KV head for
    each query head (group 1)."""
    lo, hi = q_off // g, (q_off + nq - 1) // g + 1
    if lo == kv_off and hi - lo == k.shape[1] and q_off % g == 0 and nq % g == 0:
        return k  # every KV head this rank holds, in order
    if q_off % g == 0 and nq % g == 0 or hi - lo == 1 and g % nq == 0:
        return k[:, lo - kv_off:hi - kv_off].contiguous()
    idx = torch.arange(q_off, q_off + nq, device=k.device) // g - kv_off
    return k.index_select(1, idx).contiguous()


def gqa_attention(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                  window: int, freqs: torch.Tensor, sp: tp.Split = tp.ONE) -> torch.Tensor:
    """Training attention over the whole sequence of ``x`` (B,S,d), the
    twin of the JAX package's ``gqa_attention``: causal, ``window`` on local
    layers (0 on global ones). Differentiable; returns (B,S,d). On a rank's
    blocks (``sp``): its query heads through ``ops.flash_attention`` over
    the KV heads they read, ``wo`` row-parallel (``_region``)."""
    Hp = cfg.n_heads + cfg.head_pad
    p, x = _region(p, x, cfg, sp)
    q, k, v, q_off, kv_off = _project_qkv(p, x, cfg, positions, freqs, sp)
    g, nq = Hp // cfg.n_kv_heads, q.shape[1]
    o = ops.flash_attention(q, _kv_for(k, kv_off, q_off, nq, g), _kv_for(v, kv_off, q_off, nq, g),
                            causal=True, window=window)
    return _out_split(o, q_off, p["wo"], cfg, sp)


def gqa_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                window: int, freqs: torch.Tensor, sp: tp.Split = tp.ONE
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal attention over the whole sequence of ``x`` (B,S,d). ``window``
    is the layer's sliding window (0 on global layers). Returns the output
    (B,S,d) and every KV head's K and V (B,KV,S,hd) for the cache. On a
    rank's blocks of the layer (``sp`` over several ranks): its query heads
    through ``ops.flash_attention``, then ``wo`` row-parallel."""
    KV, Hp = cfg.n_kv_heads, cfg.n_heads + cfg.head_pad
    q, k, v, q_off, kv_off = _project_qkv(p, x, cfg, positions, freqs, sp)
    g = Hp // KV
    nq = q.shape[1]
    o = ops.flash_attention(q, _kv_for(k, kv_off, q_off, nq, g), _kv_for(v, kv_off, q_off, nq, g),
                            causal=True, window=window)
    return (_out_split(o, q_off, p["wo"], cfg, sp), tp.gather_heads(k, KV, sp),
            tp.gather_heads(v, KV, sp))


def gqa_decode(p, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: torch.Tensor, cfg: ModelConfig, *, window: int,
               freqs: torch.Tensor, sp: tp.Split = tp.ONE) -> torch.Tensor:
    """One decode step for ``x`` (B,1,d) at position ``pos`` (a 0-d int32
    device tensor). Writes this step's K/V into row ``pos`` of the caches
    (B,KV,rows,hd), which hold positions ``sp.kv_start`` on, in place, and
    returns the output (B,1,d). Over several ranks (``sp``): q and the new
    K/V all-gathered over ``model``, the new row written by the rank that
    holds ``pos``, the rank's rows attended by the decode kernel's slice call
    and the partials combined over the axes that split the cache, then the
    rank's part of ``wo``."""
    B = x.shape[0]
    KV, Hp = cfg.n_kv_heads, cfg.n_heads + cfg.head_pad
    at = pos.reshape(1).long()
    q, k_new, v_new, _, _ = _project_qkv(p, x, cfg, at, freqs, sp)
    q = tp.gather_heads(q, Hp, sp)
    tp.write_row(k_cache, tp.gather_heads(k_new, KV, sp), at, sp)
    tp.write_row(v_cache, tp.gather_heads(v_new, KV, sp), at, sp)
    hd = q.shape[3]
    o, lse = ops.decode_attention(q.view(B, Hp, hd), k_cache, v_cache, pos, window=window,
                                  kv_start=sp.kv_start, return_lse=True)
    o = tp.combine(o, lse, sp).to(x.dtype)
    return _out_split(o.view(B, Hp, 1, hd), 0, p["wo"], cfg, sp)


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


def _mla_split(p, cfg: ModelConfig) -> bool:
    """True where the layer's MLA blocks are split over ``model`` (``wq_b``,
    ``wkv_b`` and ``wo`` on the heads), False where they are whole."""
    m = cfg.mla
    heads = {p["wq_b"].shape[1], p["wkv_b"].shape[1], p["wo"].shape[0]}
    if len(heads) > 1 or p["wq_b"].shape[0] != m.q_lora_rank or \
            p["wo"].shape[1] != m.v_head_dim:
        raise NotImplementedError(
            f"the MLA split takes wq_b, wkv_b and wo split on the same heads; these blocks are "
            f"{[tuple(p[k].shape) for k in ('wq_b', 'wkv_b', 'wo')]}")
    return heads.pop() != cfg.n_heads


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions, freqs, sp: tp.Split = tp.ONE):
    """q_nope (B,H,S,nope), q_rope (B,H,S,rope), latent (B,S,r), k_rope
    (B,1,S,rope); ``freqs`` at the RoPE width. On a rank's blocks (``sp``):
    ``wq_a``'s and ``wkv_a``'s output columns all-gathered over ``model``
    before their norms and the RoPE split (the input entering their
    products through ``f``), the normed q through ``f`` into ``wq_b``'s
    heads: H is this rank's heads."""
    m = cfg.mla
    xf = tp.copy_to_model(x, sp)  # the entry of the products split over model

    def down(w, width):  # x @ w, whole: a block of w's columns gathered
        if w.shape[1] == width:
            return x @ w.to(x.dtype)
        return tp.all_gather_for_replicated(xf @ w.to(x.dtype), sp, dim=2)

    q = rmsnorm(down(p["wq_a"], m.q_lora_rank), p["q_norm"])
    if p["wq_b"].shape[1] != cfg.n_heads:
        q = tp.copy_to_model(q, sp)
    q_nope, q_rope = _heads(q, p["wq_b"]).split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, freqs)
    latent, k_rope = down(p["wkv_a"], m.kv_lora_rank + m.qk_rope_head_dim).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    latent = rmsnorm(latent, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, None], positions, freqs)
    return q_nope, q_rope, latent, k_rope


def _mla_expanded(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                  freqs: torch.Tensor, sp: tp.Split = tp.ONE):
    """The expanded form's output (B,S,d) and the cache columns latent
    (B,S,r) and k_rope (B,S,rope). On a rank's heads (``sp``): latent and
    k_rope, which every rank uses for its own heads, through ``f`` into
    ``wkv_b``'s heads and k's RoPE part, ``wo`` row-parallel."""
    m = cfg.mla
    B, S, _ = x.shape
    split = _mla_split(p, cfg)
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, positions, freqs, sp)
    lat, kr = (tp.copy_to_model(latent, sp), tp.copy_to_model(k_rope, sp)) if split else \
        (latent, k_rope)
    H = p["wkv_b"].shape[1]
    k_nope, v = _heads(lat, p["wkv_b"]).split([m.qk_nope_head_dim, m.v_head_dim], -1)
    k = torch.cat([k_nope, kr.expand(B, H, S, m.qk_rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)
    o = ops.flash_attention(q, k, v.contiguous(), causal=True)  # scale (nope + rope)^-1/2
    out = _out_proj(o, p["wo"])
    return (tp.reduce_from_model(out, sp) if split else out), latent, k_rope[:, 0]


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                freqs: torch.Tensor, sp: tp.Split = tp.ONE
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA over the whole sequence of ``x`` (B,S,d), the expanded
    form. Returns the output (B,S,d) and the layer's cache columns of the
    rows this rank stores, ``[sp.kv_start, sp.kv_start + sp.rows)`` (every
    row under ``tp.ONE``): latent (B,rows,r) and k_rope (B,rows,rope). On a
    rank's blocks (``sp``): its heads through ``ops.flash_attention`` at
    (192, 128), ``wo`` row-parallel."""
    out, latent, k_rope = _mla_expanded(p, x, cfg, positions, freqs, sp)
    if sp.rows:
        latent = latent[:, sp.kv_start:sp.kv_start + sp.rows]
        k_rope = k_rope[:, sp.kv_start:sp.kv_start + sp.rows]
    return out, latent, k_rope


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, *, positions: torch.Tensor,
                  freqs: torch.Tensor, sp: tp.Split = tp.ONE) -> torch.Tensor:
    """Training MLA over the whole sequence of ``x`` (B,S,d), the twin of
    the JAX package's ``mla_attention``: the expanded form of
    ``mla_prefill``, causal, without the cache. Differentiable; returns
    (B,S,d). On a rank's blocks (``sp``): its heads through
    ``ops.flash_attention`` at (192, 128), ``wo`` row-parallel."""
    return _mla_expanded(p, x, cfg, positions, freqs, sp)[0]


def mla_decode(p, x: torch.Tensor, kv_cache: torch.Tensor, pos: torch.Tensor,
               cfg: ModelConfig, *, freqs: torch.Tensor, sp: tp.Split = tp.ONE) -> torch.Tensor:
    """One absorbed-MLA decode step for ``x`` (B,1,d) at ``pos`` (a 0-d int32
    device tensor). Writes this step's latent ++ k_rope into row ``pos`` of
    ``kv_cache`` (B,rows,r+rope), which holds positions ``sp.kv_start`` on,
    in place, and returns the output (B,1,d). On a rank's blocks (``sp``),
    as ``gqa_decode``: q_lat of the rank's heads of ``wkv_b`` gathered over
    ``model`` to every head, the new row written by the rank that holds
    ``pos``, the rank's rows through the decode kernel's slice call at
    (576, 512) and the partials combined over the axes that split the cache,
    then the rank's heads of ``wkv_b``'s v part and of ``wo``, summed over
    ``model``."""
    m = cfg.mla
    B = x.shape[0]
    H, r, nope = cfg.n_heads, m.kv_lora_rank, m.qk_nope_head_dim
    at = pos.reshape(1).long()
    split = _mla_split(p, cfg)
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, at, freqs, sp)
    rows = kv_cache[:, None]  # one cache head (B, 1, rows, r + rope); V is its latent
    tp.write_row(rows, torch.cat([latent, k_rope[:, 0]], -1)[:, None], at, sp)
    wkv_b = p["wkv_b"].to(x.dtype)  # (r, h, nope + v): this rank's heads
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, :, 0], wkv_b[:, :, :nope])
    q = tp.gather_heads(torch.cat([q_lat, q_rope[:, :, 0]], -1), H, sp).contiguous()
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ctx, lse = ops.decode_attention(q, rows, rows[..., :r], pos, scale=scale,
                                    kv_start=sp.kv_start, return_lse=True)  # (B, H, r)
    ctx = tp.combine(ctx, lse, sp).to(x.dtype)
    h = wkv_b.shape[1]
    ctx = ctx.narrow(1, tp.offset(h, H, sp), h)
    out = torch.einsum("bhr,rhv->bhv", ctx, wkv_b[:, :, nope:])
    out = out.reshape(B, 1, -1) @ p["wo"].reshape(h * m.v_head_dim, -1).to(x.dtype)
    return tp.reduce_from_model(out, sp) if split else out
