"""Whisper-style encoder-decoder (the encdec family) for serving: the torch
twin of the JAX package's ``models/whisper.py``.

The audio front end (two convolutions and a GELU in real Whisper) is a stub,
as there: ``encode`` takes its output, precomputed frame embeddings
(B, S_audio, d). After it: learned positions, pre-LN blocks, a non-gated
GELU MLP, and a decoder with causal self-attention and cross-attention over
the encoder's states. The parameters keep the JAX package's tree, leaf
names and stacked layout (``enc_layers.attn.wq`` is ``(L, d, H, hd)``), so
checkpoints move between the packages bit for bit.

Attention has no RoPE and its biases live outside the kernel: q and v carry
``bq``/``bv``, k has none, the output ``bo``. Its three shapes all run on
``ops.flash_attention``: the encoder non-causal over the frames, the
decoder's self-attention causal, and its cross-attention non-causal with
Sk = S_audio. The JAX package computes them in query chunks of 512 and
drops the remainder (``whisper.py:48``), so it fails at any length above
512 that is not a multiple of 512, the config's own 1,500 frames included
(ROADMAP.md, faults); this model computes the full attention at every
length.

``prefill`` and ``decode_step`` run under ``torch.inference_mode`` on the
module's device. The cache is the JAX package's dict: self-attention
``k``/``v`` (L, B, H, S, hd), cross-attention ``ck``/``cv`` (L, B, H,
S_audio, hd), and ``pos``, a 0-d int32 device tensor. ``decode_step``
writes K/V into the cache in place and runs ``ops.decode_attention`` twice a
layer: over the self-attention cache up to ``pos``, and over the whole
cross-attention cache (``pos`` = S_audio - 1, a device tensor made once),
so a step syncs nothing with the host.

The JAX package's ``ServeEngine`` does not serve this family (its prefill
passes no frames; ROADMAP.md, faults), so neither does the port's: serve it
through ``prefill`` and ``decode_step``. ``train_loss`` raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..data.device_loader import resolve_device
from ..kernels import ops
from .attention import _heads, _out_proj
from .common import Initializer, ParamTree, layernorm, stack_init
from .config import ModelConfig
from .transformer import _index, token_ids


def _init_attn(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": ini.fanin((d, H, hd)),
        "bq": ini.zeros((H, hd)),
        "wk": ini.fanin((d, H, hd)),
        "wv": ini.fanin((d, H, hd)),
        "bv": ini.zeros((H, hd)),
        "wo": ini.fanin((H, hd, d)),
        "bo": ini.zeros((d,)),
    }


def _init_mlp(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": ini.fanin((d, ff)), "b1": ini.zeros((ff,)),
            "w2": ini.fanin((ff, d)), "b2": ini.zeros((d,))}


def _init_ln(ini: Initializer, d: int) -> Dict[str, Any]:
    return {"scale": ini.ones((d,)), "bias": ini.zeros((d,))}


def _ln(p, x: torch.Tensor) -> torch.Tensor:
    return layernorm(x, p["scale"], p["bias"])


def _bias(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(H, hd) -> (1, H, 1, hd), to add to (B, H, S, hd)."""
    return b.to(dtype)[None, :, None, :]


def _q(p, x: torch.Tensor) -> torch.Tensor:
    """Q (+ ``bq``), (B, H, S, hd), contiguous as the kernels take it."""
    return (_heads(x, p["wq"]) + _bias(p["bq"], x.dtype)).contiguous()


def _kv(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K (no bias) and V (+ ``bv``), (B, H, S, hd) each, contiguous."""
    v = _heads(x, p["wv"]) + _bias(p["bv"], x.dtype)
    return _heads(x, p["wk"]).contiguous(), v.contiguous()


def _out(p, o: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) -> (B, S, d), + ``bo``."""
    return _out_proj(o, p["wo"]) + p["bo"].to(o.dtype)


def _mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu(x @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype), approximate="tanh")
    return h @ p["w2"].to(x.dtype) + p["b2"].to(x.dtype)


def _attend(p, xq: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool):
    o = ops.flash_attention(_q(p, xq), k, v, causal=causal)
    return _out(p, o)


class WhisperModel(nn.Module):
    """Encoder-decoder with the JAX package's parameters.

    ``device`` defaults to the current CUDA device and raises without one
    (pass ``device="cpu"`` to run on the CPU, or ``"meta"`` for a shape-only
    model that a checkpoint restore fills). Weights are random, drawn from
    ``torch.Generator(seed)`` at the JAX package's init scales."""

    def __init__(self, cfg: ModelConfig, *, device: Any = None, seed: int = 0):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"WhisperModel is the encdec family, not {cfg.family}")
        self.cfg = cfg
        device = resolve_device(device)
        ini = Initializer(device, cfg.pdtype, seed)
        d = cfg.d_model

        def enc_layer():
            return {"ln1": _init_ln(ini, d), "attn": _init_attn(ini, cfg),
                    "ln2": _init_ln(ini, d), "mlp": _init_mlp(ini, cfg)}

        def dec_layer():
            return {"ln1": _init_ln(ini, d), "self_attn": _init_attn(ini, cfg),
                    "ln_x": _init_ln(ini, d), "cross_attn": _init_attn(ini, cfg),
                    "ln2": _init_ln(ini, d), "mlp": _init_mlp(ini, cfg)}

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t, requires_grad=False)

        self.enc_pos = param(ini.normal((cfg.enc_seq, d), scale=0.01))
        self.enc_layers = ParamTree(stack_init(cfg.n_enc_layers, enc_layer))
        self.ln_enc = ParamTree(_init_ln(ini, d))
        self.embed = param(ini.normal((cfg.vocab, d), scale=1.0 / d ** 0.5))
        self.dec_pos = param(ini.normal((cfg.max_seq, d), scale=0.01))
        self.dec_layers = ParamTree(stack_init(cfg.n_layers, dec_layer))
        self.ln_dec = ParamTree(_init_ln(ini, d))
        self._layers: Optional[Tuple[List[Any], List[Any]]] = None  # per-layer views
        self._cross_pos: Dict[int, torch.Tensor] = {}  # S_audio -> S_audio - 1 on the device

    # ---- parameters ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested params dict."""
        return {"enc_pos": self.enc_pos, "enc_layers": self.enc_layers.tree(),
                "ln_enc": self.ln_enc.tree(), "embed": self.embed, "dec_pos": self.dec_pos,
                "dec_layers": self.dec_layers.tree(), "ln_dec": self.ln_dec.tree()}

    def params_changed(self) -> None:
        """Drop the per-layer views (and the device positions) after the
        parameters were replaced."""
        self._layers = None
        self._cross_pos = {}

    def _layer_views(self) -> Tuple[List[Any], List[Any]]:
        """(encoder layers, decoder layers), each a list of per-layer views."""
        if self._layers is None:
            enc, dec = self.enc_layers.tree(), self.dec_layers.tree()
            self._layers = ([_index(enc, i) for i in range(self.cfg.n_enc_layers)],
                            [_index(dec, i) for i in range(self.cfg.n_layers)])
        return self._layers

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.embed.t().to(h.dtype)

    def _embed_tokens(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Token embeddings plus the learned positions ``positions`` (S,)."""
        cdtype = self.cfg.cdtype
        x = F.embedding(token_ids(tokens, self.device), self.embed).to(cdtype)
        return x + self.dec_pos.index_select(0, positions).to(cdtype)[None]

    # ---- encoder ------------------------------------------------------------
    @torch.inference_mode()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_audio, d), the stub front end's output. Returns the
        encoder states (B, S_audio, d) in the compute dtype. At an S_audio
        other than ``cfg.enc_seq`` the learned positions are tiled or
        cropped, as in the JAX package."""
        cdtype = self.cfg.cdtype
        x = torch.as_tensor(frames).to(device=self.device, dtype=cdtype)
        S = x.shape[1]
        pos = self.enc_pos
        if S != pos.shape[0]:
            pos = pos.repeat(-(-S // pos.shape[0]), 1)[:S]
        x = x + pos.to(cdtype)[None]
        for p in self._layer_views()[0]:
            h = _ln(p["ln1"], x)
            x = x + _attend(p["attn"], h, *_kv(p["attn"], h), causal=False)
            x = x + _mlp(p["mlp"], _ln(p["ln2"], x))
        return _ln(self.ln_enc, x)

    # ---- serving ------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Encode ``frames`` (B, S_audio, d) and run the decoder over
        ``tokens`` (B, S). Returns (last-position logits (B, V), the cache:
        self-attention K/V of capacity S, cross-attention K/V of the S_audio
        encoder states, ``pos`` = S)."""
        enc = self.encode(frames)
        B, S = tokens.shape
        x = self._embed_tokens(tokens, torch.arange(S, device=self.device))
        cache = self._alloc_cache(B, S, enc.shape[1])
        for i, p in enumerate(self._layer_views()[1]):
            xq = _ln(p["ln1"], x)
            k, v = _kv(p["self_attn"], xq)
            cache["k"][i].copy_(k)
            cache["v"][i].copy_(v)
            h = x + _attend(p["self_attn"], xq, k, v, causal=True)
            ck, cv = _kv(p["cross_attn"], enc)
            cache["ck"][i].copy_(ck)
            cache["cv"][i].copy_(cv)
            h = h + _attend(p["cross_attn"], _ln(p["ln_x"], h), ck, cv, causal=False)
            x = h + _mlp(p["mlp"], _ln(p["ln2"], h))
        logits = self._logits(_ln(self.ln_dec, x[:, -1:]))
        cache["pos"].fill_(S)
        return logits[:, 0], cache

    def _alloc_cache(self, batch: int, seq: int, enc_seq: int,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        cfg = self.cfg
        dtype = dtype or cfg.cdtype
        L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim

        def zeros(rows):
            return torch.zeros((L, batch, H, rows, hd), dtype=dtype, device=self.device)

        return {"k": zeros(seq), "v": zeros(seq), "ck": zeros(enc_seq), "cv": zeros(enc_seq),
                "pos": torch.zeros((), dtype=torch.int32, device=self.device)}

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Any]:
        """A zeroed cache of self-attention capacity ``seq`` and
        ``cfg.enc_seq`` cross-attention rows, on the module's device."""
        return self._alloc_cache(batch, seq, self.cfg.enc_seq, dtype)

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the self-attention
        cache in place and returns (logits (B, V), the cache with
        ``pos + 1``)."""
        cfg = self.cfg
        pos = cache["pos"]
        at = pos.reshape(1).long()
        B = tokens.shape[0]
        H, hd = cfg.n_heads, cfg.head_dim
        S_audio = cache["ck"].shape[3]
        cross_pos = self._cross_pos.get(S_audio)
        if cross_pos is None:
            cross_pos = torch.tensor(S_audio - 1, dtype=torch.int32, device=self.device)
            self._cross_pos[S_audio] = cross_pos
        x = self._embed_tokens(tokens, at)
        for i, p in enumerate(self._layer_views()[1]):
            sa, ca = p["self_attn"], p["cross_attn"]
            xq = _ln(p["ln1"], x)
            k_new, v_new = _kv(sa, xq)
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            k_cache.index_copy_(2, at, k_new.to(k_cache.dtype))
            v_cache.index_copy_(2, at, v_new.to(v_cache.dtype))
            o = ops.decode_attention(_q(sa, xq).reshape(B, H, hd), k_cache, v_cache, pos)
            h = x + _out(sa, o.view(B, H, 1, hd))
            q = _q(ca, _ln(p["ln_x"], h)).reshape(B, H, hd)
            o = ops.decode_attention(q, cache["ck"][i], cache["cv"][i], cross_pos)
            h = h + _out(ca, o.view(B, H, 1, hd))
            x = h + _mlp(p["mlp"], _ln(p["ln2"], h))
        logits = self._logits(_ln(self.ln_dec, x))
        cache["pos"] = pos + 1
        return logits[:, 0], cache

    # ---- train --------------------------------------------------------------
    def train_loss(self, batch: Dict[str, Any]):
        raise NotImplementedError(
            "WhisperModel training is not ported yet (ROADMAP.md, modules to port, item 10): "
            "its cross-attention needs a flash_attention backward with Sq != Sk (kernel item "
            "K9); the port serves this family")
