"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local:global attention (sliding window 1024), head_dim 256 (explicit),
QK-norm, sandwich norms, RoPE theta 10k local / 1M global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    max_seq=131072,
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    qk_norm=True,
    sandwich_norm=True,
    norm="rmsnorm",
    mlp_act="gelu",
    mlp_gated=True,          # GeGLU
    embed_scale=True,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
