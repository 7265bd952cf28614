"""Analytic roofline estimators on a stated :class:`Hardware`."""

from .roofline import (H100_SXM, Hardware, flops_per_token,
                       stage_hbm_fraction, stage_tokens_per_sec)
