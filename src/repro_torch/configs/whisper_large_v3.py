"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder; the conv/mel
frontend is a STUB: ``input_specs`` feeds precomputed frame embeddings
(B, enc_seq, d_model).  32 enc + 32 dec layers, d_model=1280 20H
d_ff=5120 vocab=51866.  (Deviation noted in DESIGN.md: rope+rmsnorm
instead of learned-pos+layernorm — backbone compute is unchanged.)"""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, n_enc_layers=32, enc_seq=1500,
    d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866,
    qkv_bias=False, tie_embeddings=False,
    act="gelu", norm="rmsnorm", rope=True,
    source="arXiv:2212.04356 (unverified)",
)
