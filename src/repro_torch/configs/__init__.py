"""Architecture configs carried by the port (one module per arch) + registry.

All ten architectures of the reference's pool, in its ``ARCHS`` order:
dense (minicpm-2b, minitron-4b, qwen2.5-32b, qwen2-72b), moe
(moonshot-v1-16b-a3b, kimi-k2-1t-a32b), hybrid (zamba2-1.2b), audio
(whisper-large-v3), ssm (mamba2-370m) and vlm (phi-3-vision-4.2b), in
``ARCHS``; and the port's own models, beyond the reference's pool, in
``PORT_ARCHS``: hybrid_moe (nemotron-3-nano-30b-a3b).  ``get_config``
finds either.
"""

from .base import ModelConfig
from . import (minicpm_2b, minitron_4b, qwen2_5_32b, qwen2_72b,
               moonshot_v1_16b_a3b, kimi_k2_1t_a32b, zamba2_1_2b,
               whisper_large_v3, mamba2_370m, phi_3_vision_4_2b,
               nemotron_3_nano_30b_a3b)

ARCHS = {
    m.CONFIG.name: m.CONFIG
    for m in (minicpm_2b, minitron_4b, qwen2_5_32b, qwen2_72b,
              moonshot_v1_16b_a3b, kimi_k2_1t_a32b, zamba2_1_2b,
              whisper_large_v3, mamba2_370m, phi_3_vision_4_2b)
}


PORT_ARCHS = {m.CONFIG.name: m.CONFIG for m in (nemotron_3_nano_30b_a3b,)}


def get_config(name: str) -> ModelConfig:
    try:
        return {**ARCHS, **PORT_ARCHS}[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted({**ARCHS, **PORT_ARCHS})}") from None
