"""llava-next-mistral-7b [vlm]: Mistral-7B backbone (32L d=4096 32H GQA kv=8
d_ff=14336 vocab=32000, SWA 4096) + anyres vision frontend STUB: input_specs
provides precomputed patch embeddings (B, n_patches, d).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    max_seq=32768,
    sliding_window=4096,
    global_every=0,          # all layers sliding-window (mistral)
    norm="rmsnorm",
    mlp_act="silu",
    mlp_gated=True,
    rope_theta=10_000.0,
    n_patches=1152,          # anyres: 2 tiles x 576 patches (stubbed)
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)
