"""The port's streaming runtime: operators (each body a CUDA kernel),
micro-batch streams, an executor that enacts a planned Schedule on the card
(the "Storm" substrate of the reproduction), deterministic fault
injection, and the live enactment layer mirroring FleetController deltas
onto running executors.  A copy of the reference's ``runtime`` on torch
devices."""

from .operators import OPERATORS, SERVICE_LATENCY, Operator, make_operator
from .stream import MicroBatch, SyntheticSource, VirtualClock, WallClock
from .chaos import (Fault, FaultEvent, FaultInjector, FaultKind, FaultPlan,
                    FaultTimeline, InjectedOperatorError, null_injector)
from .executor import (ExecutionReport, RebindInfo, RobustnessPolicy,
                       StreamExecutor)
from .enact import (EnactRecord, EnactmentLog, LiveFleet, transplant_map)

__all__ = [k for k in dir() if not k.startswith("_")]
