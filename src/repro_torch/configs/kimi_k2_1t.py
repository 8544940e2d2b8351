"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8 per assignment
sheet; real K2 uses MLA — we follow the sheet, deviation noted in DESIGN.md)
d_ff=2048(expert) vocab=163840; 1 shared + 384 routed top-8.
[arXiv:2501.kimi2; unverified]"""

from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,            # 7168 / 64
    d_ff=18432,              # dense-prefix hidden
    vocab=163840,
    max_seq=131072,
    attn_type="gqa",
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, d_ff_expert=2048,
                  capacity_factor=1.25, router="sigmoid", dispatch_chunks=8, first_dense=1),
    norm="rmsnorm",
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=50_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    attn_chunk=128,          # bound f32 score transients (128H x S)
    remat=True,
    opt_moment_dtype="int8",
)
