"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — 2 shared + 64 routed top-6,
fine-grained experts.  28L d_model=2048 16H (kv=16) d_ff=1408(per-expert)
vocab=102400.  (The real model's first layer is a dense FFN; every layer
here is MoE, as in the JAX package, for uniform stacking.)"""
from repro_torch.models import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    qkv_bias=False, tie_embeddings=False,
    act="swiglu", norm="rmsnorm", rope=True,
    moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    source="arXiv:2401.06066; hf",
)
