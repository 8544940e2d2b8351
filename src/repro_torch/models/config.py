"""Unified model configuration covering all 10 assigned architectures.

A copy of the JAX package's ``models/config.py``: every field, ``reduced()``
and ``param_count()`` are the same, so one configuration means the same
model in both packages. Only ``pdtype``/``cdtype`` differ: they return
``torch.dtype``s."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named like numpy/JAX names it (``"bfloat16"``)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 8
    n_shared: int = 0             # shared (always-on) experts
    d_ff_expert: int = 0          # per-expert hidden
    capacity_factor: float = 1.25
    router: str = "sigmoid"       # 'sigmoid' (deepseek-v3/kimi) or 'softmax'
    aux_loss_coef: float = 0.001
    first_dense: int = 0          # leading dense layers (deepseek: 3)
    dispatch_chunks: int = 1      # scan MoE over token chunks (memory bound)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: int = 12
    head_dim: int = 0             # 0 => d_model // n_heads
    d_ff: int = 3072
    vocab: int = 32000
    max_seq: int = 131072

    # attention
    attn_type: str = "gqa"        # gqa | mla | none
    head_pad: int = 0             # extra ZERO q-heads for TP divisibility (exact no-op)
    attn_chunk: int = 512         # query-block size for chunked attention
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0       # 0 = full attention
    # layer pattern: e.g. gemma3 5 local : 1 global. global_every=0 => all full.
    global_every: int = 0         # every Nth layer is global (rest sliding window)
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0  # gemma3 global layers use different theta

    # norms / mlp
    norm: str = "rmsnorm"         # rmsnorm | layernorm | layernorm_np (non-parametric)
    sandwich_norm: bool = False   # gemma3: post-attn + post-ffn norms too
    mlp_act: str = "silu"         # silu (SwiGLU) | gelu (GeGLU or plain)
    mlp_gated: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False     # gemma: scale embeddings by sqrt(d)
    logit_softcap: float = 0.0

    # extras
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp: bool = False             # deepseek multi-token-prediction depth-1
    mtp_weight: float = 0.3

    # hybrid (zamba2): shared attention block every k ssm layers
    hybrid_attn_every: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500           # whisper encoder positions after conv stub

    # vlm (llava): patch embeddings prepended to the token sequence
    n_patches: int = 0

    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = True

    # optimizer memory plan (used by the distributed runtime)
    opt_moment_dtype: str = "float32"   # 'int8' => blockwise-quantized moments

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ---------------------------------------------------------
    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm.headdim if self.ssm else 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            max_seq=512,
            scan_layers=self.scan_layers,
            remat=False,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1), first_dense=min(self.moe.first_dense, 1),
                dispatch_chunks=1,
            )
        if self.mla:
            kw["mla"] = MLAConfig(
                q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32,
            )
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, headdim=32, chunk=32)
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_seq"] = 64
        if self.n_patches:
            kw["n_patches"] = 16
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
            kw["n_layers"] = 4
        if self.sliding_window:
            kw["sliding_window"] = 64
        return self.with_(**kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        per_layer = 0
        if self.hybrid_attn_every:
            # zamba2: ONE shared attention(2d)+MLP block reused at invocations
            hd2 = 2 * d // self.n_heads
            shared = 2 * d * self.n_heads * hd2 * 3      # wq,wk,wv over concat
            shared += self.n_heads * hd2 * 2 * d         # wo back to 2d width
            shared += 2 * d * d                          # out_proj 2d->d
            shared += (3 if self.mlp_gated else 2) * d * ff
            n += shared
        elif self.attn_type == "gqa":
            hd, H, KV = self.head_dim, self.n_heads, self.n_kv_heads
            per_layer += d * H * hd + 2 * d * KV * hd + H * hd * d
            if self.qkv_bias:
                per_layer += (H + 2 * KV) * hd
        elif self.attn_type == "mla":
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        if self.ssm:
            di, N, H = self.d_inner, self.ssm.d_state, self.n_ssm_heads
            G = self.ssm.n_groups
            per_layer_ssm = d * (2 * di + 2 * G * N + H)  # in_proj
            per_layer_ssm += self.ssm.conv_width * (di + 2 * G * N)  # conv
            per_layer_ssm += H * 2 + di  # A, D, dt_bias... approx
            per_layer_ssm += di * d  # out_proj
            per_layer += per_layer_ssm
        if self.moe and self.moe.n_experts:
            ffe = self.moe.d_ff_expert
            moe_layer = d * self.moe.n_experts  # router
            moe_layer += self.moe.n_experts * 3 * d * ffe
            moe_layer += self.moe.n_shared * 3 * d * ffe
            dense_layer = 3 * d * ff if self.mlp_gated else 2 * d * ff
            n += self.moe.first_dense * dense_layer + (L - self.moe.first_dense) * moe_layer
        elif not self.ssm:
            n += L * (3 * d * ff if self.mlp_gated else 2 * d * ff)
        n += L * per_layer
        if self.n_enc_layers:  # whisper encoder
            hd, H = self.head_dim, self.n_heads
            enc = d * H * hd * 4 + (3 * d * ff if self.mlp_gated else 2 * d * ff)
            # decoder cross-attn
            n += self.n_enc_layers * enc + L * (d * H * hd * 4)
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top_k experts)."""
        if not (self.moe and self.moe.n_experts):
            return self.param_count()
        full = self.param_count()
        d, ffe = self.d_model, self.moe.d_ff_expert
        L_moe = self.n_layers - self.moe.first_dense
        all_experts = L_moe * self.moe.n_experts * 3 * d * ffe
        active_experts = L_moe * self.moe.top_k * 3 * d * ffe
        return int(full - all_experts + active_experts)
