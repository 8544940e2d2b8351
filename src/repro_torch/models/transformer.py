"""Decoder-only transformer LM, dense family: the torch twin of the JAX
package's ``models/transformer.py`` for training and serving.

The parameters keep the JAX package's stacked layout: one ``ParamTree``
``dense_layers`` whose every leaf has the layer count as its leading axis
(``wq`` is ``(L, d, H, hd)``), so checkpoints move between the packages bit
for bit. A Python loop over layers indexes ``w[i]`` (a view) where the JAX
package runs ``lax.scan``; per-layer behaviour (gemma3's local/global
pattern and its two RoPE bases) is fixed on the host per layer, so only
local layers hand a window to the attention kernel.

``prefill`` and ``decode_step`` run under ``torch.inference_mode`` and on
the module's device. The KV cache is a dict of stacked ``(L, B, KV, S, hd)``
tensors and ``pos``, a 0-d int32 tensor on the device; ``decode_step``
writes into the cache in place and returns it with ``pos + 1``, and syncs
nothing with the host.

``train_loss`` is the JAX package's next-token loss. Its layers run with
autograd on: the attention through ``ops.flash_attention`` (forward and
backward kernels on the card), each layer under ``torch.utils.checkpoint``
where ``cfg.remat`` is set (``jax.checkpoint`` there), and the loss over
256-token pieces of the sequence, each checkpointed, so the full (B,S,V)
logits never exist at once. The parameters are built with
``requires_grad=False`` for serving; a trainer turns them on
(``model.requires_grad_(True)``).

The vlm family (llava-next) is this model with ``mm_proj`` (d, d): its
``prefill`` and ``train_loss`` take the stub vision front end's patch
embeddings (B, P, d), project them, prepend them to the tokens and run the
layers over ``P + S`` positions; the loss scores the text positions only.
``decode_step`` and the engine are text-only, as the JAX package's are. MoE
and MTP raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.device_loader import resolve_device
from .attention import gqa_attention, gqa_decode, gqa_prefill, init_gqa
from .common import (
    Initializer,
    ParamTree,
    cross_entropy_loss,
    embed_lookup,
    make_norm,
    rope_freqs,
    softcap,
    stack_init,
)
from .config import ModelConfig
from .ffn import init_mlp, mlp


def _init_layer(ini: Initializer, cfg: ModelConfig) -> Dict[str, Any]:
    norm_init, _ = make_norm(cfg.norm)
    d = cfg.d_model
    p: Dict[str, Any] = {"ln_attn": norm_init(ini, d), "ln_mlp": norm_init(ini, d)}
    if cfg.sandwich_norm:
        p["ln_attn_post"] = norm_init(ini, d)
        p["ln_mlp_post"] = norm_init(ini, d)
    p["attn"] = init_gqa(ini, cfg)
    p["ffn"] = init_mlp(ini, cfg)
    return p


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked params dict: views, no copies."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree: Any, n: int) -> List[Any]:
    """Every layer of a stacked params dict as views, one ``unbind`` a leaf:
    under autograd each leaf's gradient is then stacked once from its
    layers' (where ``tree[i]`` would build a full-size gradient a layer)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(tree.unbind(0))


def token_ids(tokens: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Token ids as int64 on ``device``. uint32 tokens (the token dataset's
    dtype) are read as int32 by their bits first, which holds for any vocab
    below 2**31, so no uint32 kernel is needed on either device."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(tokens)
    if tokens.dtype == torch.uint32:
        tokens = tokens.view(torch.int32)
    return tokens.to(device=device, dtype=torch.int64)


class TransformerLM(nn.Module):
    """Dense decoder-only LM with the JAX package's parameters.

    ``device`` defaults to the current CUDA device and raises without one
    (pass ``device="cpu"`` to run on the CPU, or ``"meta"`` for a shape-only
    model that a checkpoint restore fills). Weights are random, drawn from
    ``torch.Generator(seed)`` at the JAX package's init scales."""

    def __init__(self, cfg: ModelConfig, *, device: Any = None, seed: int = 0):
        super().__init__()
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(_not_ported(cfg.family))
        if cfg.moe and cfg.moe.n_experts:
            raise NotImplementedError(_not_ported("moe"))
        if cfg.attn_type != "gqa":
            raise NotImplementedError(f"{cfg.attn_type} attention is not ported yet "
                                      "(ROADMAP.md, modules to port, item 10)")
        if cfg.mtp:
            raise NotImplementedError("multi-token prediction (mtp) is not ported yet "
                                      "(ROADMAP.md, modules to port, item 10)")
        self.cfg = cfg
        self.n_dense = cfg.n_layers
        device = resolve_device(device)
        ini = Initializer(device, cfg.pdtype, seed)
        norm_init, _ = make_norm(cfg.norm)
        self.embed = nn.Parameter(
            ini.normal((cfg.vocab, cfg.d_model), scale=1.0 / cfg.d_model ** 0.5),
            requires_grad=False,
        )
        self.ln_f = ParamTree(norm_init(ini, cfg.d_model))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                ini.normal((cfg.d_model, cfg.vocab), scale=1.0 / cfg.d_model ** 0.5),
                requires_grad=False,
            )
        self.dense_layers = ParamTree(stack_init(self.n_dense, lambda: _init_layer(ini, cfg)))
        if cfg.n_patches:  # projects the (stub) vision encoder's patch embeddings
            self.mm_proj = nn.Parameter(ini.fanin((cfg.d_model, cfg.d_model)),
                                        requires_grad=False)
        self._freqs: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}
        self._layers: Optional[List[Dict[str, Any]]] = None  # per-layer views, made lazily

    # ---- parameters ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested params dict."""
        tree: Dict[str, Any] = {"embed": self.embed, "ln_f": self.ln_f.tree()}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        tree["dense_layers"] = self.dense_layers.tree()
        if self.cfg.n_patches:
            tree["mm_proj"] = self.mm_proj
        return tree

    # ---- helpers ------------------------------------------------------------
    def _layer_flags(self, n: int, offset: int = 0) -> List[Tuple[bool, float]]:
        """(is_global, rope_theta) per layer, on the host."""
        cfg = self.cfg
        theta_g = cfg.rope_theta_global or cfg.rope_theta
        flags = []
        for i in range(offset, offset + n):
            if cfg.global_every:
                is_global = (i + 1) % cfg.global_every == 0
            else:
                is_global = not cfg.sliding_window  # all local (mistral) or all global
            flags.append((is_global, theta_g if is_global else cfg.rope_theta))
        return flags

    def params_changed(self) -> None:
        """Drop the per-layer views after the parameters were replaced."""
        self._layers = None

    def _windows(self) -> List[Tuple[int, float]]:
        """(window, rope base) per layer; the window only on local layers."""
        return [(0 if is_global else self.cfg.sliding_window, theta)
                for is_global, theta in self._layer_flags(self.n_dense)]

    def _layer_args(self) -> List[Tuple[Dict[str, Any], int, torch.Tensor]]:
        """(params, window, rope freqs) per layer; the window only on local
        layers."""
        if self._layers is None:
            stacked = self.dense_layers.tree()
            self._layers = [_index(stacked, i) for i in range(self.n_dense)]
        return [(p, window, self._rope(self.cfg.head_dim, theta))
                for p, (window, theta) in zip(self._layers, self._windows())]

    def _rope(self, head_dim: int, theta: float) -> torch.Tensor:
        """RoPE frequencies for serving, made once per device."""
        key = (head_dim, theta, self.device)
        if key not in self._freqs:
            self._freqs[key] = rope_freqs(head_dim, theta, device=self.device)
        return self._freqs[key]

    def _embed_inputs(self, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, d) token embeddings; with ``patch_embeds`` (B, P, d) and a
        vlm config, those projected by ``mm_proj`` in the compute dtype and
        prepended: (B, P + S, d). A config without patches ignores them, as
        the reference does."""
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens.to(self.device), cfg.embed_scale, cfg.cdtype)
        if patch_embeds is None or not cfg.n_patches:
            return x
        pe = torch.as_tensor(patch_embeds).to(device=self.device, dtype=cfg.cdtype)
        return torch.cat([pe @ self.mm_proj.to(cfg.cdtype), x], dim=1)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = self.embed.t() if cfg.tie_embeddings else self.lm_head
        return softcap(h @ head.to(h.dtype), cfg.logit_softcap)

    def _block(self, p, x, attn) -> torch.Tensor:
        """One layer around its attention ``attn(h) -> a``."""
        _, norm = make_norm(self.cfg.norm)
        a = attn(norm(p["ln_attn"], x))
        if self.cfg.sandwich_norm:
            a = norm(p["ln_attn_post"], a)
        x = x + a
        f = mlp(p["ffn"], norm(p["ln_mlp"], x), self.cfg)
        if self.cfg.sandwich_norm:
            f = norm(p["ln_mlp_post"], f)
        return x + f

    # ---- train --------------------------------------------------------------
    def _backbone(self, x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layers and the final norm with autograd on: (h, aux loss).
        Per-layer views and RoPE tables are made anew each call (the serving
        caches may hold inference tensors)."""
        cfg = self.cfg
        layers = _unstack(self.dense_layers.tree(), self.n_dense)
        freqs = {theta: rope_freqs(cfg.head_dim, theta, device=self.device)
                 for _, theta in self._windows()}
        for p, (window, theta) in zip(layers, self._windows()):
            def layer(x, p=p, window=window, f=freqs[theta]):
                return self._block(p, x, lambda h: gqa_attention(
                    p["attn"], h, cfg, positions=positions, window=window, freqs=f))

            x = checkpoint(layer, x, use_reentrant=False) if cfg.remat else layer(x)
        _, norm = make_norm(cfg.norm)
        return norm(self.ln_f, x), torch.zeros((), dtype=torch.float32, device=self.device)

    def _chunked_ce(self, h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
        """CE and accuracy over ``chunk``-token pieces, each checkpointed, so
        the full (B,S,V) logits never exist at once."""
        S = h.shape[1]
        chunk = min(chunk, S)

        def piece(hc, lc, mc):
            loss, acc = cross_entropy_loss(self._logits(hc), lc, mc)
            cnt = torch.clamp_min(torch.sum(mc.to(torch.float32)), 1e-9)
            return loss * cnt, acc * cnt, cnt

        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        tl = ta = tc = zero
        for lo in range(0, S, chunk):  # the last piece holds the remainder
            hi = min(S, lo + chunk)
            l, a, c = checkpoint(piece, h[:, lo:hi], labels[:, lo:hi], mask[:, lo:hi],
                                 use_reentrant=False)
            tl, ta, tc = tl + l, ta + a, tc + c
        return tl / torch.clamp_min(tc, 1e-9), ta / torch.clamp_min(tc, 1e-9)

    def train_loss(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: ``tokens`` (B,S) [+ ``patch_embeds`` (B,P,d), vlm]. The
        next-token LM loss over the text positions, on the module's device:
        labels are the tokens shifted by one, the last position masked.
        Returns (loss, {"ce", "aux", "acc", "loss"}), all 0-d f32."""
        tokens = token_ids(batch["tokens"], self.device)
        x = self._embed_inputs(tokens, batch.get("patch_embeds"))
        positions = torch.arange(x.shape[1], device=self.device)
        h, aux = self._backbone(x, positions)
        h = h[:, h.shape[1] - tokens.shape[1]:]  # the text positions, after the patches
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=self.device)
        mask[:, -1] = 0.0
        loss, acc = self._chunked_ce(h, labels, mask)
        total = loss + aux
        return total, {"ce": loss, "aux": aux, "acc": acc, "loss": total}

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S), after ``patch_embeds`` (B, P, d)
        when given (vlm); returns (last-position logits (B, V), cache with
        capacity P + S and ``pos`` = P + S)."""
        cfg = self.cfg
        x = self._embed_inputs(tokens, patch_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)
        cache = self.empty_cache(B, S)
        for i, (p, window, freqs) in enumerate(self._layer_args()):
            def attn(h, p=p, i=i, window=window, freqs=freqs):
                a, k, v = gqa_prefill(p["attn"], h, cfg, positions=positions,
                                      window=window, freqs=freqs)
                cache["dense"]["k"][i].copy_(k)
                cache["dense"]["v"][i].copy_(v)
                return a

            x = self._block(p, x, attn)
        _, norm = make_norm(cfg.norm)
        logits = self._logits(norm(self.ln_f, x[:, -1:, :]))
        cache["pos"].fill_(S)
        return logits[:, 0], cache

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A zeroed KV cache of capacity ``seq`` on the module's device."""
        cfg = self.cfg
        dtype = dtype or cfg.cdtype
        shape = (self.n_dense, batch, cfg.n_kv_heads, seq, cfg.head_dim)
        return {
            "dense": {
                "k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
            },
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the cache in place and
        returns (logits (B, V), the cache with ``pos + 1``)."""
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed_inputs(tokens)
        for i, (p, window, freqs) in enumerate(self._layer_args()):
            k_cache, v_cache = cache["dense"]["k"][i], cache["dense"]["v"][i]
            x = self._block(p, x, lambda h, p=p, kc=k_cache, vc=v_cache, w=window, f=freqs:
                            gqa_decode(p["attn"], h, kc, vc, pos, cfg, window=w, freqs=f))
        _, norm = make_norm(cfg.norm)
        logits = self._logits(norm(self.ln_f, x))
        cache["pos"] = pos + 1
        return logits[:, 0], cache


def _not_ported(family: str) -> str:
    if family in ("ssm", "hybrid", "encdec"):
        return ("TransformerLM serves the dense and vlm families; the ssm, hybrid and "
                "encdec families are Mamba2LM, Zamba2LM and WhisperModel (build_model)")
    return (f"the {family} family is not ported yet (ROADMAP.md, modules to port, "
            "item 10); the port serves the dense, vlm, ssm, hybrid and encdec families")
