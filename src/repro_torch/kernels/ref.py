"""Plain PyTorch oracles for every kernel (re-exported from the model
layers, where the same functions serve as the default implementations),
and the kernels' own plain versions."""
from ..models.attention import _flash_fwd_impl, flash_attention_ref  # noqa: F401
from ..models.attention import naive_attention  # noqa: F401
from ..models.layers import rmsnorm_ref, ssm_scan_ref  # noqa: F401
from .flash_attention import flash_attention_fwd_plain  # noqa: F401
from .mamba_scan import mamba_scan_bwd_plain, mamba_scan_plain  # noqa: F401
from .rmsnorm import rmsnorm_plain  # noqa: F401
