"""paper_lm: the end-to-end example model — a small dense LM whose training
run demonstrates the paper's contribution (the RawArray data pipeline +
checkpoint plane) on CPU. ~5M params (d=256, 4L) trains a few
hundred steps in minutes on this 1-core CPU container (~2.4 s/step at 75
GFLOP/s); scale n_layers/d_model up for the ~100M variant on real hardware."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper_lm",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    d_ff=1024,
    vocab=4096,
    max_seq=256,
    norm="rmsnorm",
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="float32",
)
