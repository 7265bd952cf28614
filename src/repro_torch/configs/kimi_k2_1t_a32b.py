"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384e top-8 + 1 shared — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    shared_experts=1,
)
