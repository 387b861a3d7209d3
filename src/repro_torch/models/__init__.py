"""PyTorch port of the model zoo: every family of the JAX package, for training."""
from .model import ArchConfig, MoECfg, SSMCfg, init, params_count, train_loss

__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "init", "params_count", "train_loss"]
