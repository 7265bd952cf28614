"""Architecture configs carried by the port (one module per arch) + registry.

Only the serving slice's model is registered so far; the other families of
the reference's pool wait for their slices (see ROADMAP.md).
"""

from .base import ModelConfig
from . import minicpm_2b

ARCHS = {m.CONFIG.name: m.CONFIG for m in (minicpm_2b,)}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None
