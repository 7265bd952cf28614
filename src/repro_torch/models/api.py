"""Uniform model API over the port's model modules."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Params]
    prefill: Callable[..., Tuple[torch.Tensor, Dict]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict]]
    init_cache: Callable[..., Dict]


def get_model(cfg: ModelConfig) -> ModelApi:
    """The decoder's entry points (dense, ssm and hybrid families) bound to
    ``cfg``.  The training ``forward`` and the other families' modules wait
    for their slices (see ROADMAP.md)."""
    mod = transformer
    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None, dtype=torch.float32: mod.init(
            cfg, gen, device=device, dtype=dtype),
        prefill=lambda env, params, batch, max_len=None: mod.prefill(
            env, cfg, params, batch, max_len),
        decode_step=lambda env, params, cache, batch: mod.decode_step(
            env, cfg, params, cache, batch),
        init_cache=lambda batch, max_len, env, dtype=torch.bfloat16:
            mod.init_cache(cfg, batch, max_len, env, dtype),
    )
