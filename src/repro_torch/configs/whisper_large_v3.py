"""whisper-large-v3 [audio]: enc-dec, 32L decoder (and 32L encoder)
d_model=1280 20H (kv=20) d_ff=5120 vocab=51866 — conv frontend STUBBED:
input_specs() provides precomputed frame embeddings (B, 1500, d_model).
[arXiv:2212.04356; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq=1500,
)
