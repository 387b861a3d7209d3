"""Granite-20B code model [arXiv:2405.04324; hf] — llama-arch with MQA.
52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    qkv_bias=False, tie_embeddings=False,
    act="swiglu", norm="rmsnorm", rope=True,
    source="arXiv:2405.04324; hf",
)
