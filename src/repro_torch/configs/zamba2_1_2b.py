"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d_model=2048 (ssm_state=64) + ONE
shared attention(+MLP) block (32H MHA kv=32, d_ff=8192) invoked every 6
layers over concat([x, x0]). vocab=32000. [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,            # attends over 2*d_model=4096 => 4096/32
    d_ff=8192,
    vocab=32000,
    max_seq=1048576,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128),
    norm="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
