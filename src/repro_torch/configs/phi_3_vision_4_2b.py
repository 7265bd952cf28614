"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend STUBBED: input_specs()
provides precomputed patch embeddings prepended to the token stream.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    num_patches=576,
)
