"""The port's LM substrate: the decoder (dense, moe, vlm, ssm and hybrid
families), the whisper encoder-decoder, and their building blocks."""

from .api import ModelApi, get_model
from .common import Env, default_env, resolve_device
from .convert import params_from_jax
