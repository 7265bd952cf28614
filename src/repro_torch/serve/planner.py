"""Model-driven serving planner — the paper's technique applied to serving
the LM on GPUs.

Disaggregated serving is a streaming dataflow:

    requests --> [ prefill ] --sel=gen_len--> [ decode ] --> sink

"Threads" are GPUs, a "slot" is one 8-GPU NVLink host, and the PerfModel
P(tau) = requests-or-tokens/s of the stage with tau GPUs on one host comes
from the analytic roofline (:mod:`repro_torch.distributed.roofline`) on a
stated :class:`~repro_torch.distributed.roofline.Hardware`.  MBA picks GPUs
per stage at each stage's best operating point; SAM gangs each stage's GPUs
onto exclusive hosts, which is gang scheduling of a model-parallel group on
one NVLink island.  ``plan_serving_fleet`` shares one host budget across
many workloads through the fleet planner (:func:`~repro_torch.core.fleet.
plan_fleet`), with the same ``hardware`` argument as ``plan_serving``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from ..configs.base import ModelConfig
from ..core.dag import Dataflow
from ..core.fleet import FleetPlan, plan_fleet
from ..core.mapping import (VM_CLASS_FAMILIES, vm_class_family,
                            vm_classes_from_sizes)
from ..core.perfmodel import PAPER_MODELS, ModelLibrary, PerfModel
from ..core.scheduler import Schedule, plan
from ..distributed.roofline import (H100_SXM, Hardware, stage_hbm_fraction,
                                    stage_tokens_per_sec)

GPUS_PER_HOST = 8

#: Host classes of the serving pool: whole 8-GPU hosts sold in groups of
#: 4, 2 and 1 — the same sizes as the reference's "tpu-host" family, so the
#: two planners acquire identical pools for identical allocations.
GPU_HOST_FAMILY = "gpu-host"
VM_CLASS_FAMILIES.setdefault(
    GPU_HOST_FAMILY, vm_classes_from_sizes((4, 2, 1), prefix="gpu-host"))


def serving_perf_models(cfg: ModelConfig, *, prompt_len: int, gen_len: int,
                        batch: int, hardware: Hardware = H100_SXM,
                        max_chips_per_host: int = GPUS_PER_HOST
                        ) -> ModelLibrary:
    """PerfModels for the prefill/decode stages: tau = GPUs on one host.

    Rates are normalized to *requests/s* for prefill and *generated
    tokens/s / gen_len = requests/s-equivalent* for decode, so GetRate's
    selectivity bookkeeping stays in request units end-to-end.
    """
    lib = ModelLibrary()
    for stage in ("prefill", "decode"):
        pts = {}
        for tau in range(1, max_chips_per_host + 1):
            context = prompt_len if stage == "prefill" else prompt_len + gen_len
            tps = stage_tokens_per_sec(cfg, chips=tau, batch=batch,
                                       context=context, stage=stage,
                                       hardware=hardware)
            if stage == "prefill":
                rate = tps / prompt_len          # requests/s
            else:
                rate = tps                        # decode tokens/s
            cpu = min(1.0, tau / max_chips_per_host)
            mem = min(1.0, stage_hbm_fraction(
                cfg, chips=tau, batch=batch, context=context,
                hardware=hardware) / max_chips_per_host * tau)
            pts[tau] = (rate, cpu, mem)
        lib.add(PerfModel.from_points(stage, pts))
    lib.add(PAPER_MODELS["source"])
    lib.add(PAPER_MODELS["sink"])
    return lib


def serving_dag(gen_len: int, name: str = "serving") -> Dataflow:
    df = Dataflow(name)
    df.add_task("src", "source", is_source=True)
    df.add_task("prefill", "prefill")
    df.add_task("decode", "decode")
    df.add_task("snk", "sink", is_sink=True)
    df.add_edge("src", "prefill", selectivity=1.0)
    # each admitted request emits gen_len decode steps
    df.add_edge("prefill", "decode", selectivity=float(gen_len))
    df.add_edge("decode", "snk", selectivity=1.0 / gen_len)
    return df


@dataclasses.dataclass
class ServingPlan:
    schedule: Schedule
    models: ModelLibrary
    request_rate: float
    prefill_chips: int
    decode_chips: int
    hosts: int
    hardware: Hardware

    def describe(self) -> str:
        return (f"ServingPlan: {self.request_rate:g} req/s -> "
                f"prefill={self.prefill_chips} GPUs, "
                f"decode={self.decode_chips} GPUs on {self.hosts} hosts "
                f"({self.schedule.acquired_slots} host-slots) "
                f"[{self.hardware.name}]")


def plan_serving(cfg: ModelConfig, *, request_rate: float, prompt_len: int,
                 gen_len: int, batch: int = 32,
                 hardware: Hardware = H100_SXM,
                 allocator: str = "mba", mapper: str = "sam") -> ServingPlan:
    """MBA+SAM GPU allocation for a target request rate."""
    models = serving_perf_models(cfg, prompt_len=prompt_len, gen_len=gen_len,
                                 batch=batch, hardware=hardware)
    dag = serving_dag(gen_len)
    # hosts expose GPUS_PER_HOST "threads" per slot; VM sizes in host units
    schedule = plan(dag, request_rate, models, allocator=allocator,
                    mapper=mapper, vm_sizes=vm_class_family(GPU_HOST_FAMILY))
    alloc = schedule.allocation.tasks
    return ServingPlan(
        schedule=schedule,
        models=models,
        request_rate=request_rate,
        prefill_chips=alloc["prefill"].threads,
        decode_chips=alloc["decode"].threads,
        hosts=len(schedule.vms),
        hardware=hardware,
    )


@dataclasses.dataclass
class ServingWorkload:
    """One tenant's serving demand for the fleet planner."""

    name: str
    cfg: ModelConfig
    prompt_len: int
    gen_len: int
    batch: int = 32
    weight: float = 1.0
    priority: int = 0


def plan_serving_fleet(workloads: Sequence[ServingWorkload], *,
                       budget_hosts: int, objective: str = "max_min",
                       allocator: str = "mba", mapper: Optional[str] = "sam",
                       step: float = 0.25, max_rate: float = 64.0,
                       hardware: Hardware = H100_SXM) -> FleetPlan:
    """Share one GPU host budget across many serving workloads.

    Each workload gets its own analytic stage PerfModels on ``hardware``
    and its own serving DAG (per-DAG model libraries — "prefill" means
    something different per arch / context length); the fleet planner then
    jointly picks the admitted request rate per workload under
    ``objective`` exactly as for stream DAGs: hosts are slots, GPUs are
    threads, and gang-scheduling a stage's GPUs onto exclusive hosts is
    SAM on an NVLink island.
    """
    dags: Dict[str, Dataflow] = {}
    libs: Dict[str, ModelLibrary] = {}
    weights: Dict[str, float] = {}
    priorities: Dict[str, int] = {}
    for wl in workloads:
        if wl.name in dags:
            raise ValueError(f"duplicate workload name {wl.name!r}")
        dags[wl.name] = serving_dag(wl.gen_len, name=wl.name)
        libs[wl.name] = serving_perf_models(
            wl.cfg, prompt_len=wl.prompt_len, gen_len=wl.gen_len,
            batch=wl.batch, hardware=hardware)
        weights[wl.name] = wl.weight
        priorities[wl.name] = wl.priority
    return plan_fleet(dags, libs, budget_slots=budget_hosts,
                      objective=objective, weights=weights,
                      priorities=priorities, allocator=allocator,
                      mapper=mapper, step=step, max_rate=max_rate,
                      vm_sizes=vm_class_family(GPU_HOST_FAMILY))
