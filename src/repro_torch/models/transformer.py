"""Decoder-only transformer LM, dense, vlm and moe families: the torch twin
of the JAX package's ``models/transformer.py`` for training and serving.

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

The moe family (DeepSeek-V3, Kimi-K2) has two stacks, as the reference:
``dense_layers`` (the ``first_dense`` prefix) and ``moe_layers``, whose FFN
is ``models/moe.py``; the cache has a group for each. DeepSeek-V3 attends
by MLA (``models/attention.py``): its cache group holds ``kv`` (L, B, S,
kv_lora + rope) a stack, with ``latent`` and ``k_rope`` its column views
under the reference's names. Its MTP parameters (``mtp``: ``proj``, one
dense ``layer``, ``ln``) are part of the parameters, so checkpoints cross
with the reference's; training uses them (``_mtp_loss``), serving does not.

``train_loss`` is the JAX package's next-token loss. Its layers run with
autograd on, both stacks in order: the attention through
``ops.flash_attention`` (forward and backward kernels on the card; MLA in
its expanded form at (192, 128)), each layer under
``torch.utils.checkpoint`` where ``cfg.remat`` is set (``jax.checkpoint``
there), and the loss over 256-token pieces of the sequence, each
checkpointed, so the full (B,S,V) logits never exist at once. The moe
family adds the MoE aux loss (each stack's sum over its layers of each
layer's mean over its dispatch chunks) and, for DeepSeek-V3, the depth-1
MTP loss weighted by ``cfg.mtp_weight``. The parameters are built with
``requires_grad=False`` for serving; a trainer turns them on
(``model.requires_grad_(True)``).

The vlm family (llava-next) is this model with ``mm_proj`` (d, d): its
``prefill`` and ``train_loss`` take the stub vision front end's patch
embeddings (B, P, d), project them, prepend them to the tokens and run the
layers over ``P + S`` positions; the loss scores the text positions only.
``decode_step`` and the engine are text-only, as the JAX package's are.

Parameters placed on a mesh (``distributed/steps.py:shard_model``) are
``DTensor`` blocks. Every family here trains (``train_loss``) and serves
(``prefill``, ``decode_step``) on each rank's blocks of the weights, the
Megatron split of ``distributed/tensor_parallel.py``: a step hands it its
``Split``, and without one it computes under one rank's, on the whole
weights, so that the split is its only path. The MoE giants' blocks, split
over ``data`` too, are gathered at each layer's entry, keeping their
``model`` block (``_layer_weights``); no weight is gathered over
``model``, and serving attends the rank's rows of the cache. The helpers'
paths without a split (``sp`` None: the weights gathered a layer at a time
by ``distributed.sharding.gather_tree``) are the training paths of the
subclasses in ``ssm_lm.py``, which serve through the split and do not train
through it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.device_loader import resolve_device
from ..distributed import tensor_parallel as tp
from ..distributed.sharding import (Layer, gather, gather_tree, is_dtensor, layer_view,
                                   moe_ep_active)
from .attention import (
    gqa_attention,
    gqa_decode,
    gqa_prefill,
    init_gqa,
    init_mla,
    mla_attention,
    mla_decode,
    mla_prefill,
)
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
from .moe import init_moe, moe_ffn


def _init_layer(ini: Initializer, cfg: ModelConfig, *, use_moe: bool = False) -> Dict[str, Any]:
    norm_init, _ = make_norm(cfg.norm)
    d = cfg.d_model
    p: Dict[str, Any] = {"ln_attn": norm_init(ini, d), "ln_mlp": norm_init(ini, d)}
    if cfg.sandwich_norm:
        p["ln_attn_post"] = norm_init(ini, d)
        p["ln_mlp_post"] = norm_init(ini, d)
    p["attn"] = init_mla(ini, cfg) if cfg.attn_type == "mla" else init_gqa(ini, cfg)
    p["ffn"] = init_moe(ini, cfg) if use_moe else init_mlp(ini, cfg)
    return p


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked params dict, for serving without a split
    (the subclasses'): views, no copies (``sharding.layer_view``: a leaf
    sharded over several ranks stays so until the layer's entry gathers
    it)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return layer_view(tree, i)


def _unstack(tree: Any, n: int, local: bool = False) -> List[Any]:
    """Every layer of a stacked params dict as views, one ``unbind`` a leaf:
    under autograd each leaf's gradient is then stacked once from its
    layers' (where ``tree[i]`` would build a full-size gradient a layer). A
    sharded leaf gives its layers, each gathered at the layer's entry; with
    ``local``, the layers of this rank's block of it (the Megatron split:
    ``tensor_parallel.stored``, gathered over ``data`` at the layer's entry
    where the mesh splits it there)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n, local) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    if local:
        return tp.stored(tree, layers=True)
    if is_dtensor(tree):
        return [Layer(tree, i) for i in range(n)]
    return list(tree.unbind(0))


#: the MoE FFN's expert weights, which the expert-parallel FFN gathers itself
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _layer_weights(p: Dict[str, Any], use_moe: bool = False) -> Dict[str, Any]:
    """A layer's weights under a split, at its entry (in training inside its
    remat region, so the backward gathers again): this rank's blocks, those
    the mesh also splits over ``data`` gathered there
    (``tensor_parallel.weights``); the expert-parallel FFN takes its
    experts itself."""
    return tp.weights(p, EXPERT_LEAVES if use_moe and moe_ep_active() else ())


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
    """Decoder-only LM (dense, vlm, moe) with the JAX package's parameters.

    ``device`` defaults to the current CUDA device and raises without one
    (pass ``device="cpu"`` to run on the CPU, or ``"meta"`` for a shape-only
    model that a checkpoint restore fills). Weights are random, drawn from
    ``torch.Generator(seed)`` at the JAX package's init scales."""

    #: serves and trains on each rank's blocks (the Megatron split), every family
    splits = train_splits = True

    def __init__(self, cfg: ModelConfig, *, device: Any = None, seed: int = 0):
        super().__init__()
        if cfg.family not in ("dense", "vlm", "moe"):
            raise NotImplementedError(
                "TransformerLM serves the dense, vlm and moe families; the ssm, hybrid and "
                "encdec families are Mamba2LM, Zamba2LM and WhisperModel (build_model)")
        self.cfg = cfg
        m = cfg.moe
        self.n_dense = m.first_dense if m and m.n_experts else cfg.n_layers
        self.n_moe = cfg.n_layers - self.n_dense
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
        if self.n_dense:
            self.dense_layers = ParamTree(stack_init(self.n_dense, lambda: _init_layer(ini, cfg)))
        if self.n_moe:
            self.moe_layers = ParamTree(
                stack_init(self.n_moe, lambda: _init_layer(ini, cfg, use_moe=True)))
        if cfg.n_patches:  # projects the (stub) vision encoder's patch embeddings
            self.mm_proj = nn.Parameter(ini.fanin((cfg.d_model, cfg.d_model)),
                                        requires_grad=False)
        if cfg.mtp:  # DeepSeek-V3's multi-token prediction head: trained, not served
            self.mtp = ParamTree({
                "proj": ini.fanin((2 * cfg.d_model, cfg.d_model)),
                "layer": _init_layer(ini, cfg),
                "ln": norm_init(ini, cfg.d_model),
            })
        self._freqs: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}
        self._layers: Optional[List[tuple]] = None  # per-layer views, made lazily

    # ---- parameters ---------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested params dict."""
        tree: Dict[str, Any] = {"embed": self.embed, "ln_f": self.ln_f.tree()}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        for group, _, _ in self._stacks():
            tree[f"{group}_layers"] = getattr(self, f"{group}_layers").tree()
        if self.cfg.n_patches:
            tree["mm_proj"] = self.mm_proj
        if self.cfg.mtp:
            tree["mtp"] = self.mtp.tree()
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

    def _stacks(self) -> List[Tuple[str, int, bool]]:
        """(cache group, layers, MoE FFN) of each stack, in layer order; the
        group's parameters are ``<group>_layers``."""
        stacks = [("dense", self.n_dense, False), ("moe", self.n_moe, True)]
        return [s for s in stacks if s[1]]

    def params_changed(self) -> None:
        """Drop the per-layer views after the parameters were replaced."""
        self._layers = None

    def _rope_dim(self) -> int:
        """The width RoPE rotates: MLA's RoPE part, else the head width."""
        return self.cfg.mla.qk_rope_head_dim if self.cfg.attn_type == "mla" else self.cfg.head_dim

    def _layer_args(self) -> List[Tuple[Dict[str, Any], int, torch.Tensor, str, int, bool]]:
        """(params, window, rope freqs, cache group, index in the group, MoE
        FFN) per layer, in order, for serving; the window only on local
        layers. The params are this rank's blocks (``_unstack``'s views,
        made once), which ``_layer_weights`` takes at the layer's entry."""
        if self._layers is None:
            self._layers = []
            offset = 0
            for group, n, use_moe in self._stacks():
                layers = _unstack(getattr(self, f"{group}_layers").tree(), n, local=True)
                for i, (p, (is_global, theta)) in enumerate(
                        zip(layers, self._layer_flags(n, offset))):
                    window = 0 if is_global else self.cfg.sliding_window
                    self._layers.append((p, window, theta, group, i, use_moe))
                offset += n
        return [(p, window, self._rope(self._rope_dim(), theta), group, i, use_moe)
                for p, window, theta, group, i, use_moe in self._layers]

    def _rope(self, head_dim: int, theta: float) -> torch.Tensor:
        """RoPE frequencies for serving, made once per device."""
        key = (head_dim, theta, self.device)
        if key not in self._freqs:
            self._freqs[key] = rope_freqs(head_dim, theta, device=self.device)
        return self._freqs[key]

    def _embed_inputs(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None,
                      sp: Optional[tp.Split] = None) -> torch.Tensor:
        """(B, S, d) token embeddings; with ``patch_embeds`` (B, P, d) and a
        vlm config, those projected by ``mm_proj`` in the compute dtype and
        prepended: (B, P + S, d). A config without patches ignores them, as
        the reference does. Under a split ``sp``, on this rank's blocks: the
        vocab-parallel lookup, ``mm_proj`` column-parallel with its output
        all-gathered; else on the gathered weights."""
        cfg = self.cfg
        leaf = gather if sp is None else tp.weight
        x = tp.embed(leaf(self.embed), tokens.to(self.device), cfg.vocab, sp or tp.ONE,
                     lambda table, ids: embed_lookup(table, ids, cfg.embed_scale, cfg.cdtype))
        if patch_embeds is None or not cfg.n_patches:
            return x
        pe = torch.as_tensor(patch_embeds).to(device=self.device, dtype=cfg.cdtype)
        proj = leaf(self.mm_proj)
        y = pe @ proj.to(cfg.cdtype)
        if proj.shape[1] != cfg.d_model:  # joins the residual stream: whole on every rank
            y = tp.all_gather_for_replicated(y, sp, dim=2)
        return torch.cat([y, x], dim=1)

    def _head(self, sp: Optional[tp.Split] = None) -> torch.Tensor:
        """The output projection (d, V): under a split ``sp`` this rank's
        vocab columns (``lm_head``'s block, or the tied ``embed``'s rows)."""
        leaf = gather if sp is None else tp.weight
        return leaf(self.embed).t() if self.cfg.tie_embeddings else leaf(self.lm_head)

    def _logits(self, h: torch.Tensor, sp: Optional[tp.Split] = None,
                head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Softcapped logits by ``head`` (``_head``'s): under a split ``sp``,
        this rank's vocab columns, column-parallel."""
        cfg = self.cfg
        head = self._head(sp) if head is None else head
        if sp is not None and head.shape[1] != cfg.vocab:
            h = tp.copy_to_model(h, sp)
        return softcap(h @ head.to(h.dtype), cfg.logit_softcap)

    def _final_norm(self, x: torch.Tensor, sp: Optional[tp.Split] = None) -> torch.Tensor:
        """``ln_f`` (replicated: ``shard_model`` leaves it a plain tensor), gathered
        only where a model outside a split walks its leaves."""
        _, norm = make_norm(self.cfg.norm)
        ln_f = self.ln_f.tree()
        return norm(ln_f if sp else gather_tree(ln_f), x)

    def _block(self, p, x, attn, use_moe: bool = False,
               sp: Optional[tp.Split] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One layer around its attention ``attn(h, p_attn) -> a``: (x, the
        MoE aux loss, 0-d f32, 0 for a dense FFN). The layer's parameters
        are gathered here, at its entry, where they are sharded; under a
        split ``sp`` they are this rank's blocks (``_layer_weights``)."""
        if sp is None:
            p = gather_tree(p)
        _, norm = make_norm(self.cfg.norm)
        a = attn(norm(p["ln_attn"], x), p["attn"])
        if self.cfg.sandwich_norm:
            a = norm(p["ln_attn_post"], a)
        x = x + a
        h = norm(p["ln_mlp"], x)
        if use_moe:
            f, aux = moe_ffn(p["ffn"], h, self.cfg, sp)
        else:
            f = mlp(p["ffn"], h, self.cfg, sp or tp.ONE)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.sandwich_norm:
            f = norm(p["ln_mlp_post"], f)
        return x + f, aux

    # ---- train --------------------------------------------------------------
    def _train_attention(self, p, h: torch.Tensor, positions: torch.Tensor, window: int,
                         freqs: torch.Tensor, sp: Optional[tp.Split] = None) -> torch.Tensor:
        """A layer's training attention: MLA's expanded form, or GQA with the
        layer's window (on this rank's blocks under a split ``sp``)."""
        if self.cfg.attn_type == "mla":
            return mla_attention(p, h, self.cfg, positions=positions, freqs=freqs,
                                 sp=sp or tp.ONE)
        return gqa_attention(p, h, self.cfg, positions=positions, window=window, freqs=freqs,
                             sp=sp or tp.ONE)

    def _backbone(self, x: torch.Tensor, positions: torch.Tensor,
                  sp: Optional[tp.Split] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both stacks' layers in order and the final norm, with autograd on:
        (h, aux loss), the aux summed over each stack's layers and then over
        the stacks, as the reference's ``_scan_stack`` and ``_backbone``.
        Per-layer views and RoPE tables (at ``_rope_dim``) are made anew each
        call (the serving caches may hold inference tensors). Under a split
        ``sp`` each layer computes on this rank's blocks; a layer recomputed
        by ``torch.utils.checkpoint`` repeats its forward collectives, in the
        same order on every rank."""
        cfg = self.cfg
        freqs: Dict[float, torch.Tensor] = {}
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        offset = 0
        for group, n, use_moe in self._stacks():
            layers = _unstack(getattr(self, f"{group}_layers").tree(), n, sp is not None)
            stack_aux = torch.zeros((), dtype=torch.float32, device=self.device)
            for p, (is_global, theta) in zip(layers, self._layer_flags(n, offset)):
                if theta not in freqs:
                    freqs[theta] = rope_freqs(self._rope_dim(), theta, device=self.device)

                def layer(x, p=p, window=0 if is_global else cfg.sliding_window,
                          f=freqs[theta], use_moe=use_moe):
                    return self._block(_layer_weights(p, use_moe), x,
                                       lambda h, pa: self._train_attention(
                                           pa, h, positions, window, f, sp), use_moe, sp)

                x, a = checkpoint(layer, x, use_reentrant=False) if cfg.remat else layer(x)
                stack_aux = stack_aux + a
            aux = aux + stack_aux
            offset += n
        return self._final_norm(x, sp), aux

    def _chunked_ce(self, h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 256,
                    sp: Optional[tp.Split] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """CE and accuracy over ``chunk``-token pieces, each checkpointed, so
        the full (B,S,V) logits never exist at once; under a split ``sp``,
        the vocab-parallel ``tp.cross_entropy`` of this rank's columns. A
        head the split gathers over ``data`` is gathered once for the pieces;
        any other is taken in each piece (so its gradient goes straight to
        the leaf)."""
        S = h.shape[1]
        chunk = min(chunk, S)
        leaf = self.embed if self.cfg.tie_embeddings else self.lm_head
        head = self._head(sp) if sp is not None and tp.gathers(leaf) else None

        def piece(hc, lc, mc):
            if sp is None:
                loss, acc = cross_entropy_loss(self._logits(hc, head=head), lc, mc)
            else:
                loss, acc = tp.cross_entropy(self._logits(hc, sp, head), lc, mc, self.cfg.vocab,
                                             sp, cross_entropy_loss)
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

    def train_loss(self, batch: Dict[str, Any], *, split: Optional[tp.Split] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: ``tokens`` (B,S) [+ ``patch_embeds`` (B,P,d), vlm]. The
        next-token LM loss over the text positions, on the module's device:
        labels are the tokens shifted by one, the last position masked, plus
        the MoE aux loss and, with ``cfg.mtp``, ``cfg.mtp_weight`` times the
        MTP loss. Returns (loss, {"ce", "aux", "acc", ["mtp",] "loss"}), all
        0-d f32, the same on every rank of a split. With ``split`` (the
        ``tp`` train step's over a mesh): on this rank's weight blocks, the
        gradients into them."""
        sp = (split or tp.ONE) if self.train_splits else None  # None: a subclass's gathers
        tokens = token_ids(batch["tokens"], self.device)
        x = self._embed_inputs(tokens, batch.get("patch_embeds"), sp)
        positions = torch.arange(x.shape[1], device=self.device)
        h, aux = self._backbone(x, positions) if sp is None else self._backbone(x, positions, sp)
        h = h[:, h.shape[1] - tokens.shape[1]:]  # the text positions, after the patches
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=self.device)
        mask[:, -1] = 0.0
        loss, acc = self._chunked_ce(h, labels, mask, sp=sp)
        metrics = {"ce": loss, "aux": aux, "acc": acc}
        total = loss + aux
        if self.cfg.mtp:
            metrics["mtp"] = self._mtp_loss(h, tokens, sp)
            total = total + self.cfg.mtp_weight * metrics["mtp"]
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, h: torch.Tensor, tokens: torch.Tensor, sp: tp.Split) -> torch.Tensor:
        """DeepSeek-V3's depth-1 MTP loss, the reference's ``_mtp_loss``:
        from ``h`` (B,S,d), the text positions after ``ln_f``, normed by
        ``mtp.ln`` and concatenated with the embedding of token t+1, projected
        by ``mtp.proj`` (2d, d), one dense layer (global, RoPE at
        ``cfg.rope_theta``, not under remat) predicts token t+2; the last two
        positions are masked. On this rank's blocks (``sp``): the
        vocab-parallel embedding, ``mtp.proj`` column-parallel with its
        output all-gathered into the layer's residual stream, the layer and
        the cross-entropy split as the backbone's."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        p = self.mtp.tree()
        proj = tp.weight(p["proj"])
        next_tok = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        emb_next = tp.embed(tp.weight(self.embed), next_tok, cfg.vocab, sp,
                            lambda table, ids: embed_lookup(table, ids, cfg.embed_scale,
                                                            cfg.cdtype))
        h_in = torch.cat([norm(tp.weights(p["ln"]), h), emb_next], dim=-1)
        if proj.shape[1] != cfg.d_model:
            h_in = tp.all_gather_for_replicated(tp.copy_to_model(h_in, sp) @ proj.to(h.dtype), sp,
                                                dim=2)
        else:
            h_in = h_in @ proj.to(h.dtype)
        positions = torch.arange(h_in.shape[1], device=self.device)
        freqs = rope_freqs(self._rope_dim(), cfg.rope_theta, device=self.device)
        h_out, _ = self._block(_layer_weights(p["layer"]), h_in,
                               lambda a, pa: self._train_attention(pa, a, positions, 0, freqs,
                                                                   sp), sp=sp)
        labels = torch.cat([tokens[:, 2:], tokens[:, -2:]], dim=1)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=self.device)
        mask[:, -2:] = 0.0
        return self._chunked_ce(h_out, labels, mask, sp=sp)[0]

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, patch_embeds: Optional[torch.Tensor] = None,
                *, capacity: Optional[int] = None,
                split: Optional[tp.Split] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S), after ``patch_embeds`` (B, P, d)
        when given (vlm); returns (last-position logits (B, V), cache with
        capacity P + S, or ``capacity`` positions where given, and ``pos`` =
        P + S). With ``split`` (a serve step's over a mesh): this rank's
        batch rows, its cache rows ``[kv_start, kv_start + rows)`` of the
        capacity, its vocab columns of the logits."""
        cfg = self.cfg
        sp = split or tp.ONE
        x = self._embed_inputs(tokens, patch_embeds, sp)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)
        if (capacity or S) < S:
            raise ValueError(f"a cache of capacity {capacity} cannot hold {S} positions")
        lo, rows = (split.kv_start, split.rows) if split else (0, capacity or S)
        hi = min(lo + rows, S)  # the prompt's rows held here
        cache = self.empty_cache(B, rows)
        for p, window, freqs, group, i, use_moe in self._layer_args():
            def attn(h, pa, c=cache[group], i=i, window=window, freqs=freqs):
                if cfg.attn_type == "mla":
                    a, latent, k_rope = mla_prefill(pa, h, cfg, positions=positions,
                                                    freqs=freqs, sp=sp)
                    c["latent"][i][:, :latent.shape[1]].copy_(latent)
                    c["k_rope"][i][:, :k_rope.shape[1]].copy_(k_rope)
                    return a
                a, k, v = gqa_prefill(pa, h, cfg, positions=positions, window=window,
                                      freqs=freqs, sp=sp)
                if hi > lo:
                    c["k"][i][:, :, :hi - lo].copy_(k[:, :, lo:hi])
                    c["v"][i][:, :, :hi - lo].copy_(v[:, :, lo:hi])
                return a

            x = self._block(_layer_weights(p, use_moe), x, attn, use_moe, sp)[0]
        logits = self._logits(self._final_norm(x[:, -1:, :], sp), sp)
        cache["pos"].fill_(S)
        return logits[:, 0], cache

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A zeroed KV cache of capacity ``seq`` on the module's device: a group
        a stack (``dense``, ``moe``), as the reference's. GQA: ``k``, ``v``
        (L, B, KV, S, hd). MLA: ``kv`` (L, B, S, kv_lora + rope), whose rows
        are latent ++ k_rope, and the views ``latent`` and ``k_rope`` of its
        columns."""
        cfg = self.cfg
        dtype = dtype or cfg.cdtype

        def group(n):
            if cfg.attn_type == "mla":
                r = cfg.mla.kv_lora_rank
                kv = torch.zeros((n, batch, seq, r + cfg.mla.qk_rope_head_dim), dtype=dtype,
                                 device=self.device)
                return {"kv": kv, "latent": kv[..., :r], "k_rope": kv[..., r:]}
            shape = (n, batch, cfg.n_kv_heads, seq, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device)}

        cache: Dict[str, Any] = {name: group(n) for name, n, _ in self._stacks()}
        cache["pos"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return cache

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor, *,
                    split: Optional[tp.Split] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the cache in place and
        returns (logits (B, V), the cache with ``pos + 1``); with ``split``,
        on this rank's cache rows, and its vocab columns of the logits."""
        cfg = self.cfg
        sp = split or tp.ONE
        pos = cache["pos"]
        x = self._embed_inputs(tokens, None, sp)
        for p, window, freqs, group, i, use_moe in self._layer_args():
            c = cache[group]
            if cfg.attn_type == "mla":
                def attn(h, pa, rows=c["kv"][i], f=freqs):
                    return mla_decode(pa, h, rows, pos, cfg, freqs=f, sp=sp)
            else:
                def attn(h, pa, kc=c["k"][i], vc=c["v"][i], w=window, f=freqs):
                    return gqa_decode(pa, h, kc, vc, pos, cfg, window=w, freqs=f, sp=sp)
            x = self._block(_layer_weights(p, use_moe), x, attn, use_moe, sp)[0]
        logits = self._logits(self._final_norm(x, sp), sp)
        cache["pos"] = pos + 1
        return logits[:, 0], cache
