"""Architecture configs carried by the port (one module per arch) + registry.

The serving slices' models are registered: minicpm-2b (dense), mamba2-370m
(ssm) and zamba2-1.2b (hybrid); the other families of the reference's pool
wait for their slices (see ROADMAP.md).
"""

from .base import ModelConfig
from . import mamba2_370m, minicpm_2b, zamba2_1_2b

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (minicpm_2b, mamba2_370m, zamba2_1_2b)}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None
