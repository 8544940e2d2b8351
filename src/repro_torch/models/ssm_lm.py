"""Mamba2 LM (pure SSM) and the Zamba2 hybrid (Mamba2 layers and one shared
attention block): the torch twins of the JAX package's
``models/ssm_lm.py:Mamba2LM`` and ``Zamba2LM`` for training and serving.

The parameters keep the JAX package's names and stacked layout (``embed``,
``layers.ln``, ``layers.ssm.*`` with the layer count as leading axis,
``ln_f``; Zamba2's ``shared`` block unstacked), so checkpoints move between
the packages bit for bit. A Python loop over layers takes the place of
``lax.scan``.

The SSM cache is O(1) in the sequence: per layer the f32-computed SSM state
(stored in the compute dtype, as the JAX package stores it) and the last
``conv_width - 1`` pre-conv inputs of the three convolutions, stacked on a
leading layer axis. Zamba2's cache adds one K/V cache per invocation of the
shared block. ``pos`` is a 0-d int32 tensor on the device, and
``decode_step`` writes the cache in place and syncs nothing with the host.

``train_loss`` is ``TransformerLM``'s next-token loss over ``_backbone``,
as the reference's models inherit it: the Mamba2 layers run with autograd
on through ``ops.ssd_scan`` (its backward kernel on the card), each under
``torch.utils.checkpoint`` where ``cfg.remat`` is set (``jax.checkpoint``
there); Zamba2's shared block runs outside it, its attention through the
differentiable ``ops.flash_attention``. Per-layer views and RoPE tables are
made anew each training call: the serving ones may be inference tensors.
The parameters are built with ``requires_grad=False`` for serving; a
trainer turns them on (``model.requires_grad_(True)``).

Serving (``prefill``, ``decode_step``) computes on each rank's blocks of the
weights, the Megatron split of ``distributed/tensor_parallel.py``, as
``TransformerLM`` does: a serve step hands it its ``Split``, and without one
it computes under one rank's, on the whole weights, so that the split is its
only serving path. The Mamba2 layers compute on the rank's SSM heads and
channels (``models/mamba.py``), whose state and conv windows the cache holds;
Zamba2's shared block on its heads, ``d_ff`` columns and cache rows, through
``attention.py:gqa_{prefill,decode}`` and ``ffn.py:mlp``. No weight is
gathered over ``model``. Training gathers a layer's weights whole at its
entry (``sharding.gather_tree``): its split is ROADMAP.md item 18's next
entry.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.device_loader import resolve_device
from ..distributed import tensor_parallel as tp
from ..distributed.sharding import gather_tree
from .attention import gqa_attention, gqa_decode, gqa_prefill, init_gqa
from .common import Initializer, ParamTree, make_norm, rope_freqs, stack_init
from .config import ModelConfig
from .ffn import init_mlp, mlp
from .mamba import empty_mamba_cache, init_mamba, mamba_decode, mamba_forward
from .transformer import TransformerLM, _unstack

_CACHE_KEYS = ("ssm", "conv_x", "conv_B", "conv_C")


class Mamba2LM(TransformerLM):
    """Pure-SSM LM with the JAX package's parameters. Shares the embedding,
    logits and device plumbing of ``TransformerLM``; ``device`` and ``seed``
    as there."""

    family = "ssm"
    #: serves on each rank's blocks (the Megatron split); trains on weights gathered
    #: a layer at a time (ROADMAP.md item 18)
    splits, train_splits = True, False

    def __init__(self, cfg: ModelConfig, *, device: Any = None, seed: int = 0):
        nn.Module.__init__(self)
        if cfg.family != self.family:
            raise ValueError(f"{type(self).__name__} serves the {self.family} family, "
                             f"not {cfg.family}")
        self.cfg = cfg
        device = resolve_device(device)
        ini = Initializer(device, cfg.pdtype, seed)
        norm_init, _ = make_norm(cfg.norm)
        self.embed = nn.Parameter(
            ini.normal((cfg.vocab, cfg.d_model), scale=1.0 / cfg.d_model ** 0.5),
            requires_grad=False,
        )
        self.layers = ParamTree(stack_init(cfg.n_layers, lambda: {
            "ln": norm_init(ini, cfg.d_model), "ssm": init_mamba(ini, cfg)}))
        self._init_blocks(ini)
        self.ln_f = ParamTree(norm_init(ini, cfg.d_model))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                ini.normal((cfg.d_model, cfg.vocab), scale=1.0 / cfg.d_model ** 0.5),
                requires_grad=False,
            )
        self._layers: Optional[Dict[str, Any]] = None  # serving blocks, made lazily

    def _init_blocks(self, ini: Initializer) -> None:
        """The parameters of blocks beside the Mamba2 layers: none here."""

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested params dict."""
        tree: Dict[str, Any] = {"embed": self.embed, "layers": self.layers.tree(),
                                "ln_f": self.ln_f.tree()}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        return tree

    def _serve_params(self) -> Dict[str, Any]:
        """What serving computes on, made once: ``layers``, each layer's
        weights, and the blocks beside them (``_side_blocks``), this rank's
        blocks of each (the whole weights on one rank or without a mesh).
        The ssm and hybrid families' leaves have no FSDP axis
        (``partition.py`` gives it to the MoE giants only), so what
        ``tp.weights`` hands a layer is the block the rank stores."""
        if self._layers is None:
            layers = _unstack(self.layers.tree(), self.cfg.n_layers, local=True)
            self._layers = {"layers": [tp.weights(p) for p in layers], **self._side_blocks()}
        return self._layers

    def _side_blocks(self) -> Dict[str, Any]:
        """The serving blocks of the parameters beside the Mamba2 layers: none here."""
        return {}

    def _ssm_prefill(self, p, x: torch.Tensor, cache: Dict[str, Any], i: int,
                     sp: tp.Split) -> torch.Tensor:
        """Mamba2 layer ``i`` (its weights ``p``) over the prompt; writes its
        final SSM state and conv tails into row ``i`` of the stacked ``cache``."""
        _, norm = make_norm(self.cfg.norm)
        h, (ssm, conv) = mamba_forward(p["ssm"], norm(p["ln"], x), self.cfg, return_state=True,
                                       sp=sp)
        cache["ssm"][i].copy_(ssm)
        for key, tail in (("conv_x", conv["x"]), ("conv_B", conv["B"]), ("conv_C", conv["C"])):
            # a prompt shorter than the conv's reach leaves the zeros of its padding
            cache[key][i][:, cache[key].shape[2] - tail.shape[1]:].copy_(tail)
        return x + h

    def _ssm_decode(self, p, x: torch.Tensor, cache: Dict[str, Any], i: int,
                    sp: tp.Split) -> torch.Tensor:
        """Mamba2 layer ``i`` (its weights ``p``) for one token; updates row
        ``i`` of ``cache`` in place."""
        _, norm = make_norm(self.cfg.norm)
        layer_cache = {key: cache[key][i] for key in _CACHE_KEYS}
        return x + mamba_decode(p["ssm"], norm(p["ln"], x), layer_cache, self.cfg, sp)

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                split: Optional[tp.Split] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S); returns (last-position logits
        (B, V), cache with ``pos`` = S). ``capacity`` is taken as the split
        steps pass it: the cache's size does not depend on it. With ``split``
        (a serve step's over a mesh): this rank's batch rows, its SSM heads
        and channels of the cache, its vocab columns of the logits."""
        del capacity
        sp = split or tp.ONE
        x = self._embed_inputs(tokens, None, sp)
        layers = self._serve_params()["layers"]
        cache = self.empty_cache(x.shape[0], block=layers[0]["ssm"])
        for i, p in enumerate(layers):
            x = self._ssm_prefill(p, x, cache, i, sp)
        logits = self._logits(self._final_norm(x[:, -1:, :], sp), sp)
        cache["pos"].fill_(x.shape[1])
        return logits[:, 0], cache

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int = 0, dtype: Optional[torch.dtype] = None, *,
                    block: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """A zeroed cache on the module's device; its size does not depend on
        ``seq``. With ``block`` (a layer's ``ssm`` weights on a rank), of its
        heads and channels."""
        del seq
        cache: Dict[str, Any] = empty_mamba_cache(self.cfg, batch, dtype or self.cfg.cdtype,
                                                  self.device, self.cfg.n_layers, block)
        cache["pos"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return cache

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor, *,
                    split: Optional[tp.Split] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the cache in place and
        returns (logits (B, V), the cache with ``pos + 1``); with ``split``,
        on this rank's blocks of the cache, and its vocab columns of the
        logits."""
        sp = split or tp.ONE
        x = self._embed_inputs(tokens, None, sp)
        for i, p in enumerate(self._serve_params()["layers"]):
            x = self._ssm_decode(p, x, cache, i, sp)
        logits = self._logits(self._final_norm(x, sp), sp)
        cache["pos"] = cache["pos"] + 1
        return logits[:, 0], cache

    # ---- train --------------------------------------------------------------
    def _train_layers(self) -> Callable[[int, torch.Tensor], torch.Tensor]:
        """``layer(i, x)``: Mamba2 layer ``i`` with autograd on, under
        ``torch.utils.checkpoint`` where ``cfg.remat`` is set; its views are
        unstacked anew for this call."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        layers = _unstack(self.layers.tree(), cfg.n_layers)

        def body(x, p):
            p = gather_tree(p)
            return x + mamba_forward(p["ssm"], norm(p["ln"], x), cfg)

        def layer(i, x):
            if cfg.remat:
                return checkpoint(body, x, layers[i], use_reentrant=False)
            return body(x, layers[i])

        return layer

    def _backbone(self, x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The Mamba2 layers in order and the final norm, with autograd on:
        (h, a zero f32 aux loss), as the reference's ``_backbone``."""
        del positions
        layer = self._train_layers()
        for i in range(self.cfg.n_layers):
            x = layer(i, x)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return self._final_norm(x), aux


class Zamba2LM(Mamba2LM):
    """The hybrid family: Mamba2 layers and ONE shared attention(+MLP) block,
    whose weights are reused after every ``hybrid_attn_every``-th layer.

    The block's input is ``concat([x, x0])`` (the hidden state and the
    embedding output), so its attention is ``2·d_model`` wide
    (``attn_cfg``); ``out_proj`` maps it back to ``d_model``. Each
    invocation keeps its own K/V cache. The prefill runs the Mamba2 layers
    through ``ops.ssd_scan`` and the block through ``ops.flash_attention``;
    a decode step runs the layers in plain PyTorch and the block through
    ``ops.decode_attention``. ``device`` and ``seed`` as in ``TransformerLM``."""

    family = "hybrid"

    def __init__(self, cfg: ModelConfig, *, device: Any = None, seed: int = 0):
        super().__init__(cfg, device=device, seed=seed)
        k = cfg.hybrid_attn_every
        # invocation points AFTER layers k-1, 2k-1, ... (0-indexed)
        self.invocations = [i for i in range(cfg.n_layers) if (i + 1) % k == 0]
        self._freqs: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}

    @property
    def attn_cfg(self) -> ModelConfig:
        """Shared block attends over concat([x, x0]) => width 2·d_model."""
        c = self.cfg
        return c.with_(d_model=2 * c.d_model, head_dim=2 * c.d_model // c.n_heads,
                       sliding_window=0, global_every=0, qk_norm=False, qkv_bias=False)

    def _init_blocks(self, ini: Initializer) -> None:
        cfg = self.cfg
        d = cfg.d_model
        norm_init, _ = make_norm(cfg.norm)
        self.shared = ParamTree({
            "ln_in": norm_init(ini, 2 * d),
            "attn": init_gqa(ini, self.attn_cfg),
            "out_proj": ini.fanin((2 * d, d)),
            "ln_mlp": norm_init(ini, d),
            "mlp": init_mlp(ini, cfg),
        })

    def param_tree(self) -> Dict[str, Any]:
        tree = super().param_tree()
        tree["shared"] = self.shared.tree()
        return tree

    def _segments(self) -> Tuple[List[Tuple[int, int]], int]:
        """The layer ranges [lo, hi) between invocations, and the number of
        invocations: the shared block runs after each of the first n_inv."""
        segs, lo = [], 0
        for p in self.invocations:
            segs.append((lo, p + 1))
            lo = p + 1
        if lo < self.cfg.n_layers:
            segs.append((lo, self.cfg.n_layers))
        return segs, len(self.invocations)

    def _side_blocks(self) -> Dict[str, Any]:
        """The shared block's serving blocks (``_serve_params``)."""
        return {"shared": tp.weights(self.shared.tree())}

    def _shared_block(self, p, x: torch.Tensor, x0: torch.Tensor, attn: Callable,
                      sp: Optional[tp.Split] = None) -> torch.Tensor:
        """The shared block around its attention ``attn(u) -> a`` over the
        normed ``concat([x, x0])`` (width 2d): ``out_proj`` back to d, the
        residual add, then the MLP. Under a split ``sp``, on this rank's
        blocks ``p``: ``attn``'s row-parallel ``wo`` hands back its whole
        output, all-reduced as in the dense family; ``shared/out_proj`` is
        stored split on its input (the 2d rows), so this rank takes its block
        of those columns and ``out_proj`` is row-parallel too. (A
        reduce-scatter to the block would move half the bytes of the
        all-reduce, but would need an attention output of another width than
        the layer's.) Without one (training), the weights are gathered here
        (``attn`` gathers its own)."""
        if sp is None:
            p = gather_tree(p, keep=("attn",))
        _, norm = make_norm(self.cfg.norm)
        w = p["out_proj"]
        a = attn(norm(p["ln_in"], torch.cat([x, x0], dim=-1)))
        lo = tp.offset(w.shape[0], a.shape[-1], sp or tp.ONE)
        y = a[..., lo:lo + w.shape[0]] @ w.to(x.dtype)
        if w.shape[0] != a.shape[-1]:
            y = tp.reduce_from_model(y, sp)
        x = x + y
        return x + mlp(p["mlp"], norm(p["ln_mlp"], x), self.cfg, sp or tp.ONE)

    def _run(self, x: torch.Tensor, layer: Callable, attn: Callable, shared,
             sp: Optional[tp.Split] = None) -> torch.Tensor:
        """The layers in order, then the final norm: ``layer(i, x)`` for each
        Mamba2 layer and, after each segment but the last, the shared block
        (its weights ``shared``) around ``attn(j, u)`` for invocation j."""
        x0 = x
        segs, n_inv = self._segments()
        for j, (lo, hi) in enumerate(segs):
            for i in range(lo, hi):
                x = layer(i, x)
            if j < n_inv:
                x = self._shared_block(shared, x, x0, lambda u, j=j: attn(j, u), sp)
        return self._final_norm(x, sp)

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, capacity: Optional[int] = None,
                split: Optional[tp.Split] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S); returns (last-position logits
        (B, V), cache with attention K/V of capacity S, or ``capacity``
        positions where given, and ``pos`` = S). With ``split`` (a serve
        step's over a mesh): this rank's batch rows, its SSM heads and
        channels and its K/V rows ``[kv_start, kv_start + rows)`` of the
        cache, its vocab columns of the logits."""
        sp = split or tp.ONE
        x = self._embed_inputs(tokens, None, sp)
        B, S, _ = x.shape
        if (capacity or S) < S:
            raise ValueError(f"a cache of capacity {capacity} cannot hold {S} positions")
        lo, rows = (split.kv_start, split.rows) if split else (0, capacity or S)
        hi = min(lo + rows, S)  # the prompt's rows held here
        params = self._serve_params()
        cache = self.empty_cache(B, rows, block=params["layers"][0]["ssm"])
        positions = torch.arange(S, device=self.device)
        acfg = self.attn_cfg
        freqs = self._rope(acfg.head_dim, acfg.rope_theta)

        def attn(j, u):
            a, k, v = gqa_prefill(params["shared"]["attn"], u, acfg, positions=positions,
                                  window=0, freqs=freqs, sp=sp)
            if hi > lo:
                cache["attn"]["k"][j][:, :, :hi - lo].copy_(k[:, :, lo:hi])
                cache["attn"]["v"][j][:, :, :hi - lo].copy_(v[:, :, lo:hi])
            return a

        h = self._run(x, lambda i, x: self._ssm_prefill(params["layers"][i], x, cache["ssm"], i,
                                                        sp), attn, params["shared"], sp)
        logits = self._logits(h[:, -1:, :], sp)
        cache["pos"].fill_(S)
        return logits[:, 0], cache

    # ---- train --------------------------------------------------------------
    def _backbone(self, x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_run``'s order with autograd on: the Mamba2 layers (each under
        remat where ``cfg.remat`` is set) and the shared block after each
        segment but the last, its attention ``gqa_attention`` over
        ``concat([x, x0])`` with RoPE tables made for this call and not under
        remat, as the reference's; (h, a zero f32 aux loss)."""
        acfg = self.attn_cfg
        freqs = rope_freqs(acfg.head_dim, acfg.rope_theta, device=self.device)

        def attn(j, u):
            return gqa_attention(gather_tree(self.shared.attn), u, acfg,
                                 positions=positions, window=0, freqs=freqs)

        h = self._run(x, self._train_layers(), attn, self.shared)
        return h, torch.zeros((), dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None, *,
                    block: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """A zeroed cache on the module's device: the stacked SSM caches and
        K/V of capacity ``seq`` for each invocation of the shared block (a
        rank's rows under a split). With ``block`` (a layer's ``ssm`` weights
        on a rank), the SSM caches of its heads and channels."""
        cfg, acfg = self.cfg, self.attn_cfg
        dtype = dtype or cfg.cdtype
        shape = (len(self.invocations), batch, acfg.n_kv_heads, seq, acfg.head_dim)
        cache = super().empty_cache(batch, seq, dtype, block=block)
        pos = cache.pop("pos")
        return {"ssm": cache,
                "attn": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                         "v": torch.zeros(shape, dtype=dtype, device=self.device)},
                "pos": pos}

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor, *,
                    split: Optional[tp.Split] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the cache in place and
        returns (logits (B, V), the cache with ``pos + 1``); with ``split``,
        on this rank's blocks of the cache (its SSM heads and channels, its
        K/V rows), and its vocab columns of the logits."""
        sp = split or tp.ONE
        pos = cache["pos"]
        params = self._serve_params()
        acfg = self.attn_cfg
        freqs = self._rope(acfg.head_dim, acfg.rope_theta)

        def attn(j, u):
            return gqa_decode(params["shared"]["attn"], u, cache["attn"]["k"][j],
                              cache["attn"]["v"][j], pos, acfg, window=0, freqs=freqs, sp=sp)

        h = self._run(self._embed_inputs(tokens, None, sp),
                      lambda i, x: self._ssm_decode(params["layers"][i], x, cache["ssm"], i, sp),
                      attn, params["shared"], sp)
        logits = self._logits(h, sp)
        cache["pos"] = pos + 1
        return logits[:, 0], cache
