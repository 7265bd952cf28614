"""Data pipeline: streaming host-side token pipeline scheduled by the
paper's model-driven scheduler."""

from .pipeline import (SyntheticTokens, TokenPipeline, pipeline_dag,
                       pipeline_models, plan_pipeline)
