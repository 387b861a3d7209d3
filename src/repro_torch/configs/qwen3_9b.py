"""Qwen3 ~9B — the paper's own evaluation model (§6.1).
Dimensions follow Qwen3-8B: 36L d_model=4096 32H (GQA kv=8)
d_ff=12288 vocab=151936."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-9b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936,
    qkv_bias=False, tie_embeddings=False,
    act="swiglu", norm="rmsnorm", rope=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (paper evaluation model)",
)
