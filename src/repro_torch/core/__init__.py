"""The paper's model-driven scheduler, carried over from the JAX package:
DAGs (``dag``), performance models (``perfmodel``), LSA/MBA allocation
(``allocation``) and its vectorized rate sweeps (``batch``), DSM/RSM/SAM
mapping (``mapping``), prediction (``predictor``), the fluid simulator
whose sweep engine runs on the card (``simulator``), the
simulation-guided mapper search (``search``), the end-to-end ``plan``,
failure replans and ``max_planned_rate`` (``scheduler``), multi-DAG fleet
planning and co-simulation (``fleet``), the online fleet controller
(``online``), measured-model recalibration and drift detection
(``calibrate``), the live and analytic profilers (``profiler``) and the
typed plan-integrity diagnostics behind the ``validate=`` hooks
(``diagnostics``)."""

from .diagnostics import (PlanIntegrityError, Report, Severity, Violation,
                          default_validate, raise_if_errors, resolve_validate,
                          set_default_validate)
from .dag import (ALL_DAGS, APP_DAGS, MICRO_DAGS, Dataflow, Edge, Routing,
                  Task, diamond_dag, finance_dag, grid_dag, linear_dag,
                  star_dag, traffic_dag)
from .perfmodel import (ModelLibrary, ModelPoint, PAPER_MODELS, PerfModel,
                        TrialResult, build_perf_model, latency_slope,
                        paper_library)
from .allocation import (ALLOCATORS, Allocation, TaskAllocation,
                         UnsupportableRateError, allocate_lsa, allocate_mba)
from .batch import (BatchAllocation, batch_allocate, batch_feasible,
                    batch_slots)
from .mapping import (DEFAULT_VM_SIZES, MAPPERS, PRICE_PER_SLOT_HOUR,
                      InsufficientResourcesError, Mapping, SlotId, Thread, VM,
                      VM_CLASS_FAMILIES, VmClass, acquire_vms, local_moves,
                      map_dsm, map_rsm, map_sam, mapping_signature,
                      pool_cost_per_hour, pool_speed, remap_threads,
                      resolve_vm_classes, unit_vm_like, vm_class_family,
                      vm_classes_from_sizes, vm_sizes_speed)
from .routing import RoutingPolicy
from .predictor import (GroupIndex, ResourcePrediction, ResourceSweep,
                        build_group_index, effective_capacity_matrix,
                        predict_max_rate, predict_max_rate_gi,
                        predict_resources, predict_resources_sweep)
from .scheduler import Schedule, max_planned_rate, plan, replan_on_failure
from .fleet import (FleetEntry, FleetPlan, FleetSimEntry, FleetSimReport,
                    RateDecision, SlotSurfaceCache, UnsupportableDagError,
                    fleet_resource_surfaces, plan_fleet, replan_incremental,
                    simulate_fleet)
from .online import (ControllerLog, ControllerRecord, DagArrive, DagDepart,
                     Event, EventTrace, FleetController, ModelRefresh,
                     RateChange, VmAdd, VmFail)
from .calibrate import (AutoRecalPolicy, CalibrationResult, DriftAlert,
                        KindCalibration, TaskMeasurement, detect_drift,
                        rate_error, recalibrate)
from .simulator import (DataflowSimulator, SimResult, SweepBatch, SweepRaw,
                        measured_resources, scan_kernel_cache_clear,
                        scan_kernel_cache_stats)
from .search import (CandidateResult, RankedCandidates, evaluate_candidates,
                     generate_candidates, search_mapping)

__all__ = [k for k in dir() if not k.startswith("_")]
