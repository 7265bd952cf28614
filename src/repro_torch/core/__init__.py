"""The paper's model-driven scheduler, carried over from the JAX package:
DAGs (``dag``), performance models (``perfmodel``), LSA/MBA allocation
(``allocation``), DSM/RSM/SAM mapping (``mapping``), prediction
(``predictor``), the fluid simulator whose sweep engine runs on the card
(``simulator``), the simulation-guided mapper search (``search``) and the
end-to-end ``plan`` (``scheduler``)."""

from .dag import ALL_DAGS, APP_DAGS, MICRO_DAGS, Dataflow
from .perfmodel import ModelLibrary, ModelPoint, PerfModel, paper_library
from .allocation import ALLOCATORS, Allocation, allocate_lsa, allocate_mba
from .mapping import (MAPPERS, VM, VM_CLASS_FAMILIES, VmClass, acquire_vms,
                      vm_class_family, vm_classes_from_sizes)
from .routing import RoutingPolicy
from .simulator import (DataflowSimulator, SimResult, SweepBatch, SweepRaw,
                        scan_kernel_cache_clear, scan_kernel_cache_stats)
from .search import RankedCandidates, evaluate_candidates, search_mapping
from .scheduler import Schedule, plan
