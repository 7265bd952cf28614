"""The paper's model-driven planner, carried over from the JAX package as
plain numpy code: DAGs (``dag``), performance models (``perfmodel``), LSA/MBA
allocation (``allocation``), DSM/RSM/SAM mapping (``mapping``), prediction
(``predictor``) and the end-to-end ``plan`` (``scheduler``)."""

from .dag import Dataflow
from .perfmodel import ModelLibrary, ModelPoint, PerfModel, paper_library
from .allocation import ALLOCATORS, Allocation, allocate_lsa, allocate_mba
from .mapping import (MAPPERS, VM, VM_CLASS_FAMILIES, VmClass, acquire_vms,
                      vm_class_family, vm_classes_from_sizes)
from .scheduler import Schedule, plan
