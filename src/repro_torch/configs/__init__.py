"""Model configurations (the ported subset of ``repro.configs``)."""

from .base import ModelConfig, get_config, register  # noqa: F401
