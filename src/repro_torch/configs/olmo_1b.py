"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm, SwiGLU, no biases. [arXiv:2402.00838; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    max_seq=4096,
    norm="layernorm_np",     # OLMo's non-parametric LN
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
