"""Zamba2-2.7B [arXiv:2411.15242; hf] — hybrid: Mamba2 backbone with a
single SHARED attention+MLP block applied every 6 layers (weight tied
across applications — the paper's tied-bucket case, DESIGN.md §4).
54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64.
Sub-quadratic decode (SSM states + sliding-window shared attention) ->
runs the long_500k shape."""
from repro_torch.models import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    act="swiglu", norm="rmsnorm", rope=True,
    ssm=SSMCfg(state=64, version=2, d_conv=4, expand=2, headdim=64),
    hybrid_every=6, sliding_window=4096,
    subquadratic=True,
    source="arXiv:2411.15242; hf",
)
