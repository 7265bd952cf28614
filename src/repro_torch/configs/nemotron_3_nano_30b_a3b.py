"""nemotron-3-nano-30b-a3b [hybrid_moe]: 52L d_model=2688, pattern
MEMEM*EMEMEM*...: 23 Mamba2 mixers (64 heads x 64, state 128, 8 groups of
B/C, conv 4, chunk 128, gate-first grouped norm), 23 sparse-MoE FFNs (128
relu^2 experts of 1856, top-6 by a sigmoid router with a selection bias,
routed scale 2.5, one shared expert of 3712) and 6 GQA attention layers
(32 query / 2 KV heads of 128, no rotary); vocab=131072, untied head.
31.58 B parameters.
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json]"""

from .base import HybridMoEConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = HybridMoEConfig(
    name="nemotron-3-nano-30b-a3b",
    family="hybrid_moe",
    num_layers=len(PATTERN),
    d_model=2688,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=1856,
    vocab_size=131072,
    num_experts=128,
    experts_per_token=6,
    shared_experts=1,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=128,
    layer_pattern=PATTERN,
    use_rope=False,
    ssm_heads=64,
    ssm_groups=8,
    ssm_gate_first=True,
    shared_d_ff=3712,
    routed_scale=2.5,
)
