"""Mamba2 LM (pure SSM): the torch twin of the JAX package's
``models/ssm_lm.py:Mamba2LM`` for serving.

The parameters keep the JAX package's names and stacked layout (``embed``,
``layers.ln``, ``layers.ssm.*`` with the layer count as leading axis,
``ln_f``), so checkpoints move between the packages bit for bit. A Python
loop over layers takes the place of ``lax.scan``.

The cache is O(1) in the sequence: per layer the f32-computed SSM state
(stored in the compute dtype, as the JAX package stores it) and the last
``conv_width - 1`` pre-conv inputs of the three convolutions, stacked on a
leading layer axis, plus ``pos``, a 0-d int32 tensor on the device.
``decode_step`` writes the cache in place and syncs nothing with the host.

``Zamba2LM`` (the hybrid family) raises ``NotImplementedError`` naming its
ROADMAP item, and so does ``Mamba2LM.train_loss``: training needs a backward
of ``ssd_scan``, a kernel of its own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data.device_loader import resolve_device
from .common import Initializer, ParamTree, make_norm, stack_init
from .config import ModelConfig
from .mamba import empty_mamba_cache, init_mamba, mamba_decode, mamba_forward
from .transformer import TransformerLM, _index

_CACHE_KEYS = ("ssm", "conv_x", "conv_B", "conv_C")


class Mamba2LM(TransformerLM):
    """Pure-SSM LM with the JAX package's parameters. Shares the embedding,
    logits and device plumbing of ``TransformerLM``; ``device`` and ``seed``
    as there."""

    def __init__(self, cfg: ModelConfig, *, device: Any = None, seed: int = 0):
        nn.Module.__init__(self)
        if cfg.family != "ssm":
            raise ValueError(f"Mamba2LM serves the ssm family, not {cfg.family}")
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
        self.ln_f = ParamTree(norm_init(ini, cfg.d_model))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                ini.normal((cfg.d_model, cfg.vocab), scale=1.0 / cfg.d_model ** 0.5),
                requires_grad=False,
            )
        self._layers: Optional[List[Dict[str, Any]]] = None

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

    # ---- serve --------------------------------------------------------------
    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process prompts ``tokens`` (B, S); returns (last-position logits
        (B, V), cache with ``pos`` = S)."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        x = self._embed_inputs(tokens)
        B, S, _ = x.shape
        cache = self.empty_cache(B, S)
        for i, p in enumerate(self._layer_params()):
            h, (ssm, conv) = mamba_forward(p["ssm"], norm(p["ln"], x), cfg, return_state=True)
            x = x + h
            cache["ssm"][i].copy_(ssm)
            for key, tail in (("conv_x", conv["x"]), ("conv_B", conv["B"]), ("conv_C", conv["C"])):
                # a prompt shorter than the conv's reach leaves the zeros of its padding
                cache[key][i][:, cache[key].shape[2] - tail.shape[1]:].copy_(tail)
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
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        x = self._embed_inputs(tokens)
        for i, p in enumerate(self._layer_params()):
            layer_cache = {key: cache[key][i] for key in _CACHE_KEYS}
            x = x + mamba_decode(p["ssm"], norm(p["ln"], x), layer_cache, cfg)
        logits = self._logits(norm(self.ln_f, x))
        cache["pos"] = cache["pos"] + 1
        return logits[:, 0], cache


    def train_loss(self, batch: Dict[str, Any]):
        raise NotImplementedError(
            "Mamba2 training is not ported yet: it needs a backward kernel for ssd_scan "
            "(ROADMAP.md, modules to port, item 15); the port trains the dense family")


class Zamba2LM(nn.Module):
    """The hybrid family (Mamba2 layers and one shared attention block); not
    ported yet."""

    def __init__(self, cfg: ModelConfig, **_: Any):
        raise NotImplementedError(
            f"the hybrid family ({cfg.name}, Zamba2LM) is not ported yet (ROADMAP.md, "
            "modules to port, item 9); the port serves the dense and ssm families")
