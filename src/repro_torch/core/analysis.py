"""Compatibility alias: the analysis layer lives in
:mod:`repro_torch.analysis` (a sibling package so the core never imports it
eagerly), but older notes refer to it as ``core.analysis``; keep that name
importable, as the JAX package does."""

from ..analysis import *          # noqa: F401,F403
from ..analysis import __all__    # noqa: F401
