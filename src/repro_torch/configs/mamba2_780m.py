"""mamba2-780m [ssm]: 48L d_model=1536, attn-free, vocab=50280,
ssm_state=128, headdim 64 (d_inner 3072 => 48 SSD heads), SSD chunked scan.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    max_seq=1048576,
    attn_type="none",
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128),
    norm="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
