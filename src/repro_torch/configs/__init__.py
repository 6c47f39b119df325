"""Architecture registry: the 10 assigned archs and the port-only
granite-4.0-h-small, full + smoke variants.

The port's copy of `repro.configs` (pure-Python data, kept here so the
port imports nothing of the reference)."""

from repro_torch.configs.base import ModelConfig, LayerSpec, get_config, list_archs

__all__ = ["ModelConfig", "LayerSpec", "get_config", "list_archs"]
