"""PyTorch port of the model zoo (dense and MoE decoders and pure Mamba-1 so far)."""
from .model import ArchConfig, MoECfg, SSMCfg, init, params_count, train_loss

__all__ = ["ArchConfig", "MoECfg", "SSMCfg", "init", "params_count", "train_loss"]
