"""Stream routing models (paper §8.4 + §11 future work).

Storm's *shuffle grouping* routes tuples uniformly per downstream **thread**,
so a slot receives input proportional to its thread count even when its
threads have lower per-capita capacity (the paper's main source of
planned-vs-actual deviation for SAM).  The paper's §11 names *slot-aware
routing* — weighting by per-slot capacity — as future work; we implement both
and the scheduler/simulator/predictor can be run under either.
"""

from __future__ import annotations

import enum
from typing import Dict, Mapping, Tuple

from .mapping import Mapping as ThreadMapping, SlotId
from .perfmodel import ModelLibrary


class RoutingPolicy(enum.Enum):
    SHUFFLE = "shuffle"          # uniform per-thread (Storm default)
    SLOT_AWARE = "slot_aware"    # weighted by per-slot-group model capacity


def group_rates(task: str, kind: str, task_rate: float,
                groups: Mapping[SlotId, int], models: ModelLibrary,
                policy: RoutingPolicy) -> Dict[SlotId, float]:
    """Distribute a task's input rate over its per-slot thread groups."""
    model = models[kind]
    total_threads = sum(groups.values())
    if total_threads == 0:
        return {}
    if policy is RoutingPolicy.SHUFFLE:
        return {s: task_rate * q / total_threads for s, q in groups.items()}
    caps = {s: model.I(q) for s, q in groups.items()}
    total_cap = sum(caps.values())
    if total_cap <= 0:
        # Degenerate surface (all-zero capacities): fall back to shuffle's
        # per-thread weighting, not uniform-per-slot, so the two policies
        # agree and fractions stay consistent with thread placement.
        return {s: task_rate * q / total_threads for s, q in groups.items()}
    return {s: task_rate * caps[s] / total_cap for s in groups}
