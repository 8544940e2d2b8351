"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280; MLA (q_lora 1536, kv_lora 512, rope 64); 1 shared + 256
routed experts top-8, sigmoid router; 3 dense prefix layers; MTP depth-1.
[arXiv:2412.19437; hf]"""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,              # dense-prefix layer hidden
    vocab=129280,
    max_seq=131072,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                  capacity_factor=1.25, router="sigmoid", dispatch_chunks=8, first_dense=3),
    mtp=True,
    norm="rmsnorm",
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    attn_chunk=128,          # bound f32 score transients (128H x S)
    remat=True,
    opt_moment_dtype="int8",  # 8-bit Adam moments to fit 16GiB/chip HBM
)
