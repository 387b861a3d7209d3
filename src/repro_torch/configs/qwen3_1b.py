"""Qwen3 ~1B — the paper's own evaluation model (§6.1).
Dimensions follow Qwen3-1.7B: 28L d_model=2048 16H (GQA kv=8)
d_ff=6144 vocab=151936."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936,
    qkv_bias=False, tie_embeddings=True,
    act="swiglu", norm="rmsnorm", rope=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-1.7B (paper evaluation model)",
)
