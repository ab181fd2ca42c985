"""Core: configuration shared by the port's entry points."""

from .config import PathsConfig, TrainConfig, default_train_config

__all__ = ["PathsConfig", "TrainConfig", "default_train_config"]
