"""Serving: the continuous-batching engine and the MBA/SAM serving planner."""

from .engine import Request, ServeEngine
from .planner import (GPU_HOST_FAMILY, ServingPlan, ServingWorkload,
                      plan_serving, plan_serving_fleet, serving_dag,
                      serving_perf_models)
