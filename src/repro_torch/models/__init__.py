"""PyTorch port of the model zoo (dense decoder so far)."""
from .model import ArchConfig, MoECfg, SSMCfg, init, params_count, train_loss

__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "init", "params_count", "train_loss"]
