"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias. 40 heads is the deliberately TP-awkward case
(not divisible by model=16). [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_pad=8,              # zero-padded to 48 heads: EXACT no-op numerically,
                             # 105x less prefill collective traffic (EXPERIMENTS §Perf)
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    max_seq=131072,
    qkv_bias=True,
    norm="rmsnorm",
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
