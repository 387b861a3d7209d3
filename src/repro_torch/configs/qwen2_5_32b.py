"""Qwen2.5-32B [hf] — dense, GQA kv=8, QKV bias.
64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064,
    qkv_bias=True, tie_embeddings=False,
    act="swiglu", norm="rmsnorm", rope=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-32B",
)
