"""Qwen2-VL-7B [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.
28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision
frontend is a STUB: the backbone consumes token embeddings and
3-stream (t,h,w) M-RoPE position ids from ``input_specs``."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True, tie_embeddings=False,
    act="swiglu", norm="rmsnorm", rope=True, rope_theta=1e6,
    mrope=True, mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191; hf",
)
