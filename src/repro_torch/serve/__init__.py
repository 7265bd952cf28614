"""Serving: the continuous-batching engine and the MBA/SAM serving planner."""

from .engine import Request, ServeEngine
from .planner import (GPU_HOST_FAMILY, ServingPlan, plan_serving,
                      serving_dag, serving_perf_models)
