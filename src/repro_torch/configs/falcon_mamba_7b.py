"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba1, attention-free.
64L d_model=4096 vocab=65024 ssm_state=16.  Sub-quadratic decode ->
runs the long_500k shape."""
from repro_torch.models import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    act="swiglu", norm="rmsnorm", rope=False,
    ssm=SSMCfg(state=16, version=1, d_conv=4, expand=2),
    subquadratic=True,
    source="arXiv:2410.05355 (unverified)",
)
