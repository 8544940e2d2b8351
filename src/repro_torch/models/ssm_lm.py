"""Mamba2 LM (pure SSM) and the Zamba2 hybrid (Mamba2 layers and one shared
attention block): the torch twins of the JAX package's
``models/ssm_lm.py:Mamba2LM`` and ``Zamba2LM`` for serving.

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

``train_loss`` raises ``NotImplementedError`` naming its ROADMAP item:
training needs a backward of ``ssd_scan``, a kernel of its own.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data.device_loader import resolve_device
from .attention import gqa_decode, gqa_prefill, init_gqa
from .common import Initializer, ParamTree, make_norm, stack_init
from .config import ModelConfig
from .ffn import init_mlp, mlp
from .mamba import empty_mamba_cache, init_mamba, mamba_decode, mamba_forward
from .transformer import TransformerLM, _index

_CACHE_KEYS = ("ssm", "conv_x", "conv_B", "conv_C")


class Mamba2LM(TransformerLM):
    """Pure-SSM LM with the JAX package's parameters. Shares the embedding,
    logits and device plumbing of ``TransformerLM``; ``device`` and ``seed``
    as there."""

    family = "ssm"

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
        self._layers: Optional[List[Dict[str, Any]]] = None

    def _init_blocks(self, ini: Initializer) -> None:
        """The parameters of blocks beside the Mamba2 layers: none here."""

    def param_tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested params dict."""
        tree: Dict[str, Any] = {"embed": self.embed, "layers": self.layers.tree(),
                                "ln_f": self.ln_f.tree()}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        return tree

    def _layer_params(self) -> List[Dict[str, Any]]:
        if self._layers is None:
            stacked = self.layers.tree()
            self._layers = [_index(stacked, i) for i in range(self.cfg.n_layers)]
        return self._layers

    def _ssm_prefill(self, i: int, x: torch.Tensor, cache: Dict[str, Any]) -> torch.Tensor:
        """Mamba2 layer ``i`` over the prompt; writes its final SSM state and
        conv tails into row ``i`` of the stacked ``cache``."""
        _, norm = make_norm(self.cfg.norm)
        p = self._layer_params()[i]
        h, (ssm, conv) = mamba_forward(p["ssm"], norm(p["ln"], x), self.cfg, return_state=True)
        cache["ssm"][i].copy_(ssm)
        for key, tail in (("conv_x", conv["x"]), ("conv_B", conv["B"]), ("conv_C", conv["C"])):
            # a prompt shorter than the conv's reach leaves the zeros of its padding
            cache[key][i][:, cache[key].shape[2] - tail.shape[1]:].copy_(tail)
        return x + h

    def _ssm_decode(self, i: int, x: torch.Tensor, cache: Dict[str, Any]) -> torch.Tensor:
        """Mamba2 layer ``i`` for one token; updates row ``i`` of ``cache`` in place."""
        _, norm = make_norm(self.cfg.norm)
        p = self._layer_params()[i]
        layer_cache = {key: cache[key][i] for key in _CACHE_KEYS}
        return x + mamba_decode(p["ssm"], norm(p["ln"], x), layer_cache, self.cfg)

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S); returns (last-position logits
        (B, V), cache with ``pos`` = S)."""
        _, norm = make_norm(self.cfg.norm)
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        cache = self.empty_cache(B, S)
        for i in range(self.cfg.n_layers):
            x = self._ssm_prefill(i, x, cache)
        logits = self._logits(norm(self.ln_f, x[:, -1:, :]))
        cache["pos"].fill_(S)
        return logits[:, 0], cache

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int = 0, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A zeroed cache on the module's device; its size does not depend on
        ``seq``."""
        del seq
        cache: Dict[str, Any] = empty_mamba_cache(self.cfg, batch, dtype or self.cfg.cdtype,
                                                  self.device, self.cfg.n_layers)
        cache["pos"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return cache

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the cache in place and
        returns (logits (B, V), the cache with ``pos + 1``)."""
        _, norm = make_norm(self.cfg.norm)
        x = self._embed_inputs(tokens)
        for i in range(self.cfg.n_layers):
            x = self._ssm_decode(i, x, cache)
        logits = self._logits(norm(self.ln_f, x))
        cache["pos"] = cache["pos"] + 1
        return logits[:, 0], cache

    def train_loss(self, batch: Dict[str, Any]):
        raise NotImplementedError(
            f"{type(self).__name__} training is not ported yet: it needs a backward kernel "
            "for ssd_scan (ROADMAP.md, modules to port, item 15); the port trains the dense "
            "family")


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

    def _shared_block(self, p, x: torch.Tensor, x0: torch.Tensor,
                      attn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The shared block around its attention ``attn(u) -> a`` over the
        normed ``concat([x, x0])`` (width 2d): project to d, residual add,
        then the MLP."""
        _, norm = make_norm(self.cfg.norm)
        a = attn(norm(p["ln_in"], torch.cat([x, x0], dim=-1)))
        x = x + a @ p["out_proj"].to(x.dtype)
        return x + mlp(p["mlp"], norm(p["ln_mlp"], x), self.cfg)

    def _run(self, x: torch.Tensor, layer: Callable, attn: Callable) -> torch.Tensor:
        """The layers in order, then the final norm: ``layer(i, x)`` for each
        Mamba2 layer and, after each segment but the last, the shared block
        around ``attn(j, u)`` for invocation j."""
        x0 = x
        segs, n_inv = self._segments()
        for j, (lo, hi) in enumerate(segs):
            for i in range(lo, hi):
                x = layer(i, x)
            if j < n_inv:
                x = self._shared_block(self.shared, x, x0, lambda u, j=j: attn(j, u))
        _, norm = make_norm(self.cfg.norm)
        return norm(self.ln_f, x)

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S); returns (last-position logits
        (B, V), cache with attention K/V of length S and ``pos`` = S)."""
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=self.device)
        cache = self.empty_cache(B, S)
        acfg = self.attn_cfg
        freqs = self._rope(acfg.head_dim, acfg.rope_theta)

        def attn(j, u):
            a, k, v = gqa_prefill(self.shared.attn, u, acfg, positions=positions, window=0,
                                  freqs=freqs)
            cache["attn"]["k"][j].copy_(k)
            cache["attn"]["v"][j].copy_(v)
            return a

        h = self._run(x, lambda i, x: self._ssm_prefill(i, x, cache["ssm"]), attn)
        logits = self._logits(h[:, -1:, :])
        cache["pos"].fill_(S)
        return logits[:, 0], cache

    @torch.inference_mode()
    def empty_cache(self, batch: int, seq: int, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A zeroed cache on the module's device: the stacked SSM caches and
        K/V of capacity ``seq`` for each invocation of the shared block."""
        cfg, acfg = self.cfg, self.attn_cfg
        dtype = dtype or cfg.cdtype
        n_inv = len(self.invocations)
        shape = (n_inv, batch, acfg.n_kv_heads, seq, acfg.head_dim)
        return {
            "ssm": empty_mamba_cache(cfg, batch, dtype, self.device, cfg.n_layers),
            "attn": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                     "v": torch.zeros(shape, dtype=dtype, device=self.device)},
            "pos": torch.zeros((), dtype=torch.int32, device=self.device),
        }

    @torch.inference_mode()
    def decode_step(self, cache: Dict[str, Any], tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token (B, 1) for every sequence. Writes the cache in place and
        returns (logits (B, V), the cache with ``pos + 1``)."""
        pos = cache["pos"]
        acfg = self.attn_cfg
        freqs = self._rope(acfg.head_dim, acfg.rope_theta)

        def attn(j, u):
            return gqa_decode(self.shared.attn, u, cache["attn"]["k"][j], cache["attn"]["v"][j],
                              pos, acfg, window=0, freqs=freqs)

        h = self._run(self._embed_inputs(tokens),
                      lambda i, x: self._ssm_decode(i, x, cache["ssm"]), attn)
        logits = self._logits(h)
        cache["pos"] = pos + 1
        return logits[:, 0], cache
