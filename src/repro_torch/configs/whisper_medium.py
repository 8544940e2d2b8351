"""whisper-medium [audio]: enc-dec 24+24L d_model=1024 16H d_ff=4096
vocab=51865. Conv frontend is a STUB (input_specs provides precomputed
frame embeddings). [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,             # decoder layers
    n_enc_layers=24,
    enc_seq=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    max_seq=32768,           # shape-exercise decoder cache (real max is 448)
    norm="layernorm",
    mlp_act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
