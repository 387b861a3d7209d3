"""DBRX-132B [hf:databricks/dbrx-base] — fine-grained MoE, 16e top-4.
40L d_model=6144 48H (GQA kv=8) d_ff=10752(per-expert) vocab=100352."""
from repro_torch.models import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    qkv_bias=False, tie_embeddings=False,
    act="swiglu", norm="rmsnorm", rope=True,
    moe=MoECfg(n_experts=16, top_k=4, n_shared=0, d_expert=10752),
    source="hf:databricks/dbrx-base (unverified)",
)
