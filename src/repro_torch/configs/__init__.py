"""Model configurations (the ported subset of ``repro.configs``)."""

from .base import ModelConfig, get_config, register, resolve_slo  # noqa: F401
