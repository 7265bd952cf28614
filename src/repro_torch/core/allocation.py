"""Resource allocation (paper §6): LSA (Alg. 2) and MBA (Alg. 3).

Both return, per task, the thread count ``tau_i`` and the estimated CPU% /
memory% ``(c_i, m_i)`` in units of slots (1.0 == one full slot), plus the
DAG-level slot estimate::

    rho = max(ceil(sum_i c_i), ceil(sum_i m_i))
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional

from .dag import Dataflow
from .perfmodel import ModelLibrary, PerfModel


class UnsupportableRateError(RuntimeError):
    """Raised when an allocator cannot support a task's residual rate with
    any measured thread count (a degenerate or saturated profile).

    The typed counterpart of the mapper's ``InsufficientResourcesError``:
    planners treat it as "this rate does not fit" rather than crashing, and
    unlike a bare ``assert`` it survives ``python -O``.

    Shares the diagnostic vocabulary of :mod:`repro.analysis`: ``code`` is
    a stable identifier and :meth:`to_violation` renders the error as a
    :class:`~repro.core.diagnostics.Violation` so callers can aggregate
    planner failures and verifier findings in one report.
    """

    code = "ALC_UNSUPPORTABLE_RATE"

    def __init__(self, task: str, rate: float, message: str = ""):
        super().__init__(
            message or f"rate {rate!r} unsupportable for task {task!r}")
        self.task = task
        self.rate = rate

    def to_violation(self):
        from .diagnostics import Severity, Violation
        return Violation(self.code, Severity.ERROR, f"Task[{self.task}]",
                         f"rate={self.rate!r}", str(self))


@dataclasses.dataclass
class TaskAllocation:
    """Allocation for one task: threads + estimated resources (slot units)."""

    task: str
    kind: str
    threads: int
    cpu: float
    mem: float
    rate: float                 # input rate this task must sustain
    # MBA bookkeeping consumed by SAM: threads per full bundle and the
    # number of full bundles allocated (0 for LSA).
    bundle_size: int = 0
    full_bundles: int = 0


@dataclasses.dataclass
class Allocation:
    """Whole-DAG allocation result."""

    dag: str
    omega: float
    algorithm: str
    tasks: Dict[str, TaskAllocation]

    @property
    def total_cpu(self) -> float:
        return sum(t.cpu for t in self.tasks.values())

    @property
    def total_mem(self) -> float:
        return sum(t.mem for t in self.tasks.values())

    @property
    def total_threads(self) -> int:
        return sum(t.threads for t in self.tasks.values())

    @property
    def slots(self) -> int:
        """rho — the paper's slot estimate (max of CPU- and memory-implied)."""
        return max(math.ceil(self.total_cpu - 1e-9),
                   math.ceil(self.total_mem - 1e-9), 1)


def _static_allocation(name: str, model, rate: float) -> TaskAllocation:
    """Fixed allocation for source/sink-style tasks (§8.3): one thread,
    full static CPU%/mem% regardless of rate."""
    return TaskAllocation(name, model.kind, 1, model.C(1), model.M(1), rate,
                          bundle_size=1, full_bundles=0)


def allocate_lsa(dag: Dataflow, omega: float, models: ModelLibrary) -> Allocation:
    """Linear Scaling Allocation (Alg. 2).

    Assumes one thread's peak rate / resources extrapolate linearly: add one
    thread (and one thread's worth of resources) per ``omega_bar`` of input
    rate; the trailing fraction scales resources down proportionally.
    """
    rates = dag.get_rates(omega)
    out: Dict[str, TaskAllocation] = {}
    for t in dag.topo_order():
        model = models[t.kind]
        if model.static:
            out[t.name] = _static_allocation(t.name, model, rates[t.name])
            continue
        w = rates[t.name]
        w_bar = model.omega_bar
        # floor arithmetic, not repeated subtraction: near-degenerate
        # profiles (tiny positive omega_bar) make `w -= w_bar` a float
        # no-op that never terminates.  floor(w / w_bar), not w // w_bar —
        # float floor-division can land one below floor-of-quotient, and
        # the batch path (_lsa_task) uses the division form
        full = int(math.floor(w / w_bar)) if w_bar > 0 else 0
        resid = w - full * w_bar
        tau = full
        c = model.C(1) * full
        m = model.M(1) * full
        if resid > 1e-12:
            if w_bar <= 0:
                raise UnsupportableRateError(t.name, rates[t.name])
            tau += 1
            c += model.C(1) * (resid / w_bar)
            m += model.M(1) * (resid / w_bar)
        out[t.name] = TaskAllocation(t.name, t.kind, tau, c, m, rates[t.name])
    return Allocation(dag.name, omega, "lsa", out)


def allocate_mba(dag: Dataflow, omega: float, models: ModelLibrary) -> Allocation:
    """Model Based Allocation (Alg. 3).

    Allocates *full bundles* of ``tau_hat`` threads at the task's best
    single-slot operating point ``omega_hat``, charging a whole slot (100%
    CPU and memory) per bundle — the task cannot exploit the leftover
    resources of a saturated slot, and co-locating foreign threads there
    would break the model.  The trailing rate below ``omega_hat`` gets the
    smallest adequate thread count with model-interpolated resources.
    """
    rates = dag.get_rates(omega)
    out: Dict[str, TaskAllocation] = {}
    for t in dag.topo_order():
        model = models[t.kind]
        if model.static:
            out[t.name] = _static_allocation(t.name, model, rates[t.name])
            continue
        w = rates[t.name]
        w_hat = model.omega_hat
        tau_hat = model.tau_hat
        # floor arithmetic like LSA above (and _mba_task): repeated
        # subtraction of a tiny positive omega_hat never terminates
        bundles = int(math.floor(w / w_hat)) if w_hat > 0 else 0
        resid = w - bundles * w_hat
        tau = bundles * tau_hat
        c = float(bundles)
        m = float(bundles)
        if resid > 1e-12:
            tau_prime = model.T(resid)
            if tau_prime is None or tau_prime < 1:
                raise UnsupportableRateError(
                    t.name, rates[t.name],
                    f"residual rate {resid} exceeds omega_hat for {t.kind}")
            tau += tau_prime
            if tau_prime > 1:
                c += model.C(tau_prime)
                m += model.M(tau_prime)
            else:
                c += model.C(1) * (resid / model.I(1))
                m += model.M(1) * (resid / model.I(1))
        out[t.name] = TaskAllocation(t.name, t.kind, tau, c, m, rates[t.name],
                                     bundle_size=tau_hat, full_bundles=bundles)
    return Allocation(dag.name, omega, "mba", out)


ALLOCATORS = {
    "lsa": allocate_lsa,
    "mba": allocate_mba,
}
