"""End-to-end schedule planning: model -> allocate -> acquire -> map.

Implements the paper's full pipeline (Fig. 2) with the §8.4 retry rule: when
a resource-aware mapper cannot bin-pack the allocation, acquire one more slot
and retry, reporting both the estimate and the extra slots (the green bars of
Figs. 7-8).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .allocation import ALLOCATORS, Allocation
from .dag import Dataflow
from .mapping import (DEFAULT_VM_SIZES, MAPPERS, PRICE_PER_SLOT_HOUR,
                      InsufficientResourcesError, Mapping, VM,
                      VmSizesArg, acquire_vms, pool_cost_per_hour,
                      pool_speed, unit_vm_like, vm_sizes_speed)
from .perfmodel import ModelLibrary
from .predictor import predict_max_rate, predict_resources
from .routing import RoutingPolicy

#: Give up after this many +1-slot retries (a mapper that cannot place with
#: 4x the estimate is a bug, not fragmentation).
MAX_EXTRA_SLOTS = 512


@dataclasses.dataclass
class Schedule:
    dag: Dataflow
    omega: float
    allocation: Allocation
    vms: List[VM]
    mapping: Mapping
    allocator: str
    mapper: str
    estimated_slots: int     # rho from the allocation
    acquired_slots: int      # slots actually acquired (>= rho on retries)
    #: the winning candidate's name under the reference's ``mapper="search"``,
    #: which this package does not carry yet; always None here
    search_winner: Optional[str] = None

    @property
    def extra_slots(self) -> int:
        return self.acquired_slots - self.estimated_slots

    @property
    def price_per_hour(self) -> float:
        """Pool $/hour: class prices when the VMs carry them, the paper's
        slot-proportional §7.1 price otherwise."""
        if self.vms:
            return pool_cost_per_hour(self.vms)
        return self.acquired_slots * PRICE_PER_SLOT_HOUR

    @property
    def pool_speed(self) -> float:
        """The pool's common slot speed (1.0 for the unit-slot baseline or
        when the pool is degenerate/mixed — the verifier flags mixed pools
        with RES_MIXED_SPEED)."""
        speeds = {vm.speed for vm in self.vms}
        return speeds.pop() if len(speeds) == 1 else 1.0

    def predicted_rate(self, models: ModelLibrary,
                       policy: RoutingPolicy = RoutingPolicy.SHUFFLE) -> float:
        return predict_max_rate(self.dag, self.allocation, self.mapping,
                                models, policy)

    def predicted_resources(self, models: ModelLibrary, omega: Optional[float] = None,
                            policy: RoutingPolicy = RoutingPolicy.SHUFFLE):
        return predict_resources(self.dag, self.allocation, self.mapping,
                                 models, omega if omega is not None else self.omega,
                                 policy)

    def describe(self) -> str:
        mapper = (f"{self.mapper}->{self.search_winner}"
                  if self.search_winner else self.mapper)
        lines = [f"Schedule[{self.allocator}+{mapper}] dag={self.dag.name} "
                 f"omega={self.omega:g} slots={self.acquired_slots} "
                 f"(est {self.estimated_slots}, +{self.extra_slots}) "
                 f"threads={self.allocation.total_threads}"]
        for slot, counts in sorted(self.mapping.slot_task_counts().items(),
                                   key=lambda kv: (kv[0].vm, kv[0].slot)):
            desc = ", ".join(f"{t}x{q}" for t, q in sorted(counts.items()))
            lines.append(f"  {slot}: {desc}")
        return "\n".join(lines)


def plan(dag: Dataflow, omega: float, models: ModelLibrary,
         *, allocator: str = "mba", mapper: str = "sam",
         vm_sizes: VmSizesArg = DEFAULT_VM_SIZES,
         fixed_vms: Optional[Sequence[VM]] = None,
         grow_fixed_vms: bool = False,
         allocation: Optional[Allocation] = None) -> Schedule:
    """Plan a schedule for ``dag`` at input rate ``omega``.

    ``fixed_vms`` pins the cluster (the §8.5 five-D3-VM experiments);
    otherwise VMs are acquired per §7.1 for the allocation's slot estimate,
    growing one slot at a time if the mapper reports fragmentation.  With
    ``grow_fixed_vms`` a pinned cluster applies the same §8.4 retry rule by
    appending fresh 1-slot VMs (ids above the pinned set) instead of
    propagating the mapper failure — the fleet planner's per-DAG path, which
    keeps VM ids unique across a shared pool.

    ``vm_sizes`` also accepts :class:`~repro_torch.core.mapping.VmClass`
    objects or a registered family name.  On a ``speed=s`` class the
    allocation is sized at the *effective* rate ``omega / s`` (a thread on a
    speed-``s`` slot serves ``s``× the §6 service rate) while
    ``Schedule.omega`` keeps the real rate; ``s = 1`` reproduces the
    unit-slot plans bit-identically.

    ``allocation`` skips re-allocating when the caller already holds the
    allocation for exactly (``dag``, effective ``omega``, ``allocator``).

    Not carried over yet: the ``validate=`` verifier passes and
    ``mapper="search"`` with its ``search_opts`` (see ROADMAP.md).
    """
    fixed = fixed_vms is not None
    speed = pool_speed(fixed_vms, default=1.0) if fixed \
        else vm_sizes_speed(vm_sizes)
    # effective rate: omega / 1.0 is bitwise omega, so the unit-slot
    # baseline allocates identically
    alloc = allocation if allocation is not None \
        else ALLOCATORS[allocator](dag, omega / speed, models)
    rho = alloc.slots
    map_fn = MAPPERS[mapper]

    if fixed and not grow_fixed_vms:
        vms = list(fixed_vms)
        mapping = map_fn(dag, alloc, vms, models)
        return Schedule(
            dag, omega, alloc, vms, mapping, allocator, mapper,
            estimated_slots=rho,
            acquired_slots=sum(vm.num_slots for vm in vms))

    # one §8.4 retry loop for both acquisition modes; they differ only in
    # how the next VM list grows by one slot
    vms = list(fixed_vms) if fixed else acquire_vms(rho, vm_sizes)
    last_err: Optional[Exception] = None
    for extra in range(MAX_EXTRA_SLOTS + 1):
        try:
            mapping = map_fn(dag, alloc, vms, models)
        except InsufficientResourcesError as err:
            last_err = err
            if fixed:
                vms = vms + [unit_vm_like(
                    max((vm.id for vm in vms), default=-1) + 1, vms)]
            else:
                vms = acquire_vms(rho + extra + 1, vm_sizes)
            continue
        return Schedule(
            dag, omega, alloc, vms, mapping, allocator, mapper,
            estimated_slots=rho,
            acquired_slots=sum(vm.num_slots for vm in vms))
    raise RuntimeError(
        f"mapping failed even with {MAX_EXTRA_SLOTS} extra slots") from last_err
