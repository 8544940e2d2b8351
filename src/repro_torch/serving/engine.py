"""Minimal batched serving engine on the card.

The torch twin of the JAX package's ``serving/engine.py`` for the dense,
ssm and hybrid families. Weights come from the model itself or from a RawArray
checkpoint through the cold start (``restore_pipelined`` by default: read, upload and
on-card dequant of u8 leaves overlapped; cold-start latency is checkpoint
read latency). Requests are batched with equal-length prompts, prefilled
together, then decoded step by step with a shared cache (KV for attention,
the O(1) state for SSM, both for the hybrid).

Everything runs under ``torch.inference_mode()``. The cache position
``pos`` is a 0-d int32 tensor on the device, sampled tokens stay on the
device between steps, and a decode step syncs nothing with the host: the
tokens come back to the host once, after the last step. Greedy decoding
is held to the JAX engine; ``temperature > 0`` samples from an explicit
``torch.Generator(seed)``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import restore_naive, restore_pipelined
from ..data.device_loader import resolve_device
from ..models.config import ModelConfig
from ..models.convert import load_params


class ServeEngine:
    def __init__(
        self,
        model,
        params: Any = None,
        *,
        checkpoint: Optional[str] = None,
        restore: str = "pipelined",
        device: Any = None,
    ):
        """``model`` (its weights are used unless ``params`` or ``checkpoint``
        replaces them) runs on ``device``: by default the model's own device,
        or the current CUDA device for a model on the meta device."""
        self.model = model
        self.cfg: ModelConfig = model.cfg
        if device is None and model.device.type != "meta":
            device = model.device
        self.device = resolve_device(device)
        self.cold_start = None
        if params is None and checkpoint is not None:
            from ..checkpoint import ColdStartStats

            like = model.param_tree()
            self.cold_start = ColdStartStats()
            if restore == "pipelined":
                params, _, _ = restore_pipelined(checkpoint, like, device=self.device,
                                                 stats=self.cold_start)
            elif restore == "naive":
                params, _, _ = restore_naive(checkpoint, like, device=self.device,
                                             stats=self.cold_start)
            else:
                raise ValueError(f"restore must be 'pipelined' or 'naive', got {restore!r}")
        if params is not None:
            load_params(model, params)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the engine on {self.device}")
        self.stats: Dict[str, float] = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0.0}

    @torch.inference_mode()
    def generate(
        self,
        prompts: np.ndarray,  # (B, S_prompt) int32 — equal lengths
        max_new: int = 32,
        *,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        B, S = prompts.shape
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        logits, cache = self._prefill_with_capacity(prompts, S + max_new)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prefill_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        toks = [self._sample(logits, temperature, gen)]
        for _ in range(1, max_new):
            logits, cache = self.model.decode_step(cache, toks[-1])
            toks.append(self._sample(logits, temperature, gen))
        out = torch.cat(toks, dim=1).cpu().numpy().astype(np.int32)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["tokens"] += B * max_new
        return out

    def _prefill_with_capacity(self, prompts: np.ndarray, capacity: int):
        """Prefill such that the returned cache can take ``capacity - S``
        further decode steps. By family:

        * attention (dense): prefill the first S-1 prompt tokens right-padded
          to ``capacity`` (so the cache has room; causal masking keeps the
          padding dead until it is overwritten), rewind ``pos`` to S-1, then
          feed the last prompt token as a decode step: its logits are the
          first new token's;
        * pure SSM: the cache is O(1), so a plain prefill of the prompt;
        * hybrid: the shared attention's cache is bound by its length, so
          allocate an empty cache of ``capacity`` and replay the prompt
          through ``decode_step`` one token at a time (no host sync).
        """
        B, S = prompts.shape
        family = self.cfg.family
        if family == "ssm":
            return self.model.prefill(torch.from_numpy(prompts.astype(np.int64)).to(self.device))
        if family == "hybrid":
            tokens = torch.from_numpy(prompts.astype(np.int64)).to(self.device)  # moved once
            cache = self.model.empty_cache(B, capacity)
            for t in range(S):
                logits, cache = self.model.decode_step(cache, tokens[:, t:t + 1])
            return logits, cache
        padded = np.zeros((B, capacity), dtype=np.int64)
        padded[:, : S - 1] = prompts[:, : S - 1]
        tokens = torch.from_numpy(padded).to(self.device)
        _, cache = self.model.prefill(tokens)
        cache["pos"] = torch.full((), S - 1, dtype=torch.int32, device=self.device)
        last = torch.from_numpy(np.ascontiguousarray(prompts[:, S - 1:S]).astype(np.int64))
        return self.model.decode_step(cache, last.to(self.device))

    def _sample(self, logits: torch.Tensor, temperature: float, gen) -> torch.Tensor:
        if temperature <= 0:
            return torch.argmax(logits, dim=-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    def throughput(self) -> Dict[str, float]:
        d = dict(self.stats)
        if d["decode_s"] > 0:
            d["decode_tok_per_s"] = d["tokens"] / d["decode_s"]
        return d
