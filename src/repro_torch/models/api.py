"""Uniform model API over the port's model modules."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import encdec, transformer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Params]
    forward: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    prefill: Callable[..., Tuple[torch.Tensor, Dict]]
    decode_step: Callable[..., Tuple[torch.Tensor, Dict]]
    init_cache: Callable[..., Dict]


def get_model(cfg: ModelConfig) -> ModelApi:
    """The entry points of ``cfg``'s family bound to ``cfg``: the
    encoder-decoder for audio, the decoder for every other family."""
    mod = encdec if cfg.family == "audio" else transformer
    return ModelApi(
        cfg=cfg,
        init=lambda gen, device=None, dtype=torch.float32, env=None, \
        fsdp=False: mod.init(cfg, gen, device=device, dtype=dtype, env=env,
                             fsdp=fsdp),
        forward=lambda env, params, batch: mod.forward(env, cfg, params,
                                                       batch),
        prefill=lambda env, params, batch, max_len=None: mod.prefill(
            env, cfg, params, batch, max_len),
        decode_step=lambda env, params, cache, batch: mod.decode_step(
            env, cfg, params, cache, batch),
        init_cache=lambda batch, max_len, env, dtype=torch.bfloat16:
            mod.init_cache(cfg, batch, max_len, env, dtype),
    )
