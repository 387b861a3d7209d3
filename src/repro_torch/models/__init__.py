"""PyTorch port of the model zoo: every family of the JAX package, for
training and for serving."""
from .model import (ArchConfig, MoECfg, SSMCfg, decode_step, init, init_cache, params_count,
                    prefill, train_loss)

__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "decode_step", "init", "init_cache",
           "params_count", "prefill", "train_loss"]
