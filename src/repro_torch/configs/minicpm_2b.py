"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule.
40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753,
    qkv_bias=False, tie_embeddings=True,
    act="swiglu", norm="rmsnorm", rope=True,
    source="arXiv:2404.06395; hf",
)

# WSD (warmup-stable-decay) learning-rate schedule is this arch's
# training-specific knob; wired up in repro_torch.optim.schedules.
OPTIM = {"schedule": "wsd", "peak_lr": 1e-2, "warmup_frac": 0.01,
         "decay_frac": 0.1}
