"""Streaming dataflow DAG (paper §3).

A :class:`Dataflow` is a DAG ``G = (T, E)`` whose vertices are tasks and whose
edges carry tuple streams with a *selectivity* ``sigma_ij`` (output tuples per
input tuple on that edge).  The input-rate recurrence of §6::

    omega_j = Omega                                  if t_j is a source
    omega_j = sum_{e_ij} omega_i * sigma_ij * f_ij   otherwise

where ``f_ij`` is the routing fraction of the edge (1.0 for *duplicate*
semantics — every out-edge carries the full output stream — and ``1/k`` for
*split* semantics over ``k`` out-edges, used by the Star micro-DAG hub so the
spokes see the DAG rate, per Fig. 5).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


class Routing(enum.Enum):
    """Semantics of a task's *outgoing* edge set (§2)."""

    DUPLICATE = "duplicate"  # every out-edge carries the full output rate
    SPLIT = "split"          # output rate divided equally over out-edges


@dataclasses.dataclass(frozen=True)
class Task:
    """A dataflow vertex.

    ``kind`` keys into the performance-model library (several vertices may
    share a kind, e.g. two `pi` tasks in the Finance DAG).  ``name`` is unique
    within a Dataflow.
    """

    name: str
    kind: str
    is_source: bool = False
    is_sink: bool = False


@dataclasses.dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    selectivity: float = 1.0


class Dataflow:
    """A streaming dataflow DAG with selectivity-weighted edges."""

    def __init__(self, name: str):
        self.name = name
        self.tasks: Dict[str, Task] = {}
        self.edges: List[Edge] = []
        self.routing: Dict[str, Routing] = {}

    # -- construction ------------------------------------------------------
    def add_task(self, name: str, kind: str, *, is_source: bool = False,
                 is_sink: bool = False, routing: Routing = Routing.DUPLICATE) -> Task:
        if name in self.tasks:
            raise ValueError(f"duplicate task {name!r}")
        t = Task(name, kind, is_source, is_sink)
        self.tasks[name] = t
        self.routing[name] = routing
        return t

    def add_edge(self, src: str, dst: str, selectivity: float = 1.0) -> Edge:
        for endpoint in (src, dst):
            if endpoint not in self.tasks:
                raise KeyError(f"unknown task {endpoint!r}")
        e = Edge(src, dst, selectivity)
        self.edges.append(e)
        return e

    # -- structure ---------------------------------------------------------
    def out_edges(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.src == name]

    def in_edges(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == name]

    def sources(self) -> List[Task]:
        have_in = {e.dst for e in self.edges}
        return [t for t in self.tasks.values() if t.name not in have_in]

    def sinks(self) -> List[Task]:
        have_out = {e.src for e in self.edges}
        return [t for t in self.tasks.values() if t.name not in have_out]

    def topo_order(self) -> List[Task]:
        """Kahn topological order (deterministic: insertion order tiebreak)."""
        indeg = {n: 0 for n in self.tasks}
        for e in self.edges:
            indeg[e.dst] += 1
        order: List[Task] = []
        ready = deque(n for n in self.tasks if indeg[n] == 0)
        while ready:
            n = ready.popleft()
            order.append(self.tasks[n])
            for e in self.out_edges(n):
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.tasks):
            raise ValueError(f"dataflow {self.name!r} has a cycle")
        return order

    def logic_tasks(self) -> List[Task]:
        """Tasks that are neither source nor sink (the schedulable user logic
        plus source/sink are all scheduled; this helper is for reporting)."""
        return [t for t in self.topo_order() if not (t.is_source or t.is_sink)]

    # -- rates (GetRate, §6) -------------------------------------------------
    def get_rates(self, omega: float) -> Dict[str, float]:
        """Input rate per task for DAG input rate ``omega`` (recurrence of §6),
        evaluated in topological order."""
        rates: Dict[str, float] = {}
        for t in self.topo_order():
            ins = self.in_edges(t.name)
            if not ins:
                rates[t.name] = float(omega)
            else:
                total = 0.0
                for e in ins:
                    src_out = rates[e.src] * e.selectivity
                    if self.routing[e.src] is Routing.SPLIT:
                        src_out /= max(1, len(self.out_edges(e.src)))
                    total += src_out
                rates[t.name] = total
        return rates

    def get_rate(self, task: str, omega: float) -> float:
        return self.get_rates(omega)[task]

    def critical_path_len(self) -> int:
        """Number of tasks on the longest source→sink path (latency proxy,
        §8.6: Diamond 4 < Star 5 < Linear 7)."""
        depth = {n: 1 for n in self.tasks}
        for t in self.topo_order():
            for e in self.out_edges(t.name):
                depth[e.dst] = max(depth[e.dst], depth[t.name] + 1)
        return max(depth.values())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Dataflow({self.name!r}, tasks={len(self.tasks)}, "
                f"edges={len(self.edges)})")


# ---------------------------------------------------------------------------
# The paper's evaluation dataflows (§8.3, Figs. 5 & 6).
#
# The five representative task kinds (Table 1): X=ParseXML, P=Pi,
# F=BatchFileWrite, B=AzureBlobDownload, T=AzureTableQuery.
# All selectivities are 1:1 (§8.3).  Each DAG gets an explicit source and
# sink task (kinds "source"/"sink", §8.3 static allocation).
# ---------------------------------------------------------------------------

def _with_endpoints(df: Dataflow, heads: Sequence[str], tails: Sequence[str]) -> Dataflow:
    df.add_task("src", "source", is_source=True)
    df.add_task("snk", "sink", is_sink=True)
    for h in heads:
        df.add_edge("src", h)
    for t in tails:
        df.add_edge(t, "snk")
    return df


def linear_dag() -> Dataflow:
    """Fig. 5 Linear: sequential flow; every task sees the DAG rate."""
    df = Dataflow("linear")
    order = [("x", "parse_xml"), ("p", "pi"), ("f", "batch_file_write"),
             ("b", "azure_blob"), ("t", "azure_table")]
    for n, k in order:
        df.add_task(n, k)
    for (a, _), (b, _) in zip(order, order[1:]):
        df.add_edge(a, b)
    return _with_endpoints(df, heads=["x"], tails=["t"])


def diamond_dag() -> Dataflow:
    """Fig. 5 Diamond: fan-out then fan-in (task parallelism).

    The head *splits* its output across the three middle branches so each
    branch sees the DAG input rate / 3 ... per Fig. 5's annotations all tasks
    see the DAG rate; the paper draws the fan-out with duplicate semantics
    and a fan-in that interleaves, but reports each middle task at the DAG
    rate, so the head uses SPLIT routing here.  The tail (fan-in) then sees
    the full DAG rate again.
    """
    df = Dataflow("diamond")
    df.add_task("x", "parse_xml", routing=Routing.SPLIT)
    df.add_task("p", "pi")
    df.add_task("b", "azure_blob")
    df.add_task("t", "azure_table")
    df.add_task("f", "batch_file_write")
    for mid in ("p", "b", "t"):
        df.add_edge("x", mid)
        df.add_edge(mid, "f")
    # With SPLIT at the head each branch carries Omega/3 and the fan-in sums
    # back to Omega.
    return _with_endpoints(df, heads=["x"], tails=["f"])


def star_dag() -> Dataflow:
    """Fig. 5 Star: hub-and-spoke; the hub sees 2x the DAG rate (two in-edges
    at the DAG rate), and its out-edges SPLIT so the two egress spokes see the
    DAG rate each."""
    df = Dataflow("star")
    df.add_task("b", "azure_blob")
    df.add_task("f", "batch_file_write")
    df.add_task("x", "parse_xml", routing=Routing.SPLIT)  # hub
    df.add_task("p", "pi")
    df.add_task("t", "azure_table")
    df.add_edge("b", "x")
    df.add_edge("f", "x")
    df.add_edge("x", "p")
    df.add_edge("x", "t")
    return _with_endpoints(df, heads=["b", "f"], tails=["p", "t"])


def traffic_dag() -> Dataflow:
    """Fig. 6 Traffic (GPS stream analytics, ~7 logic tasks): parse, then a
    fan-out to speed analytics / archival, with DB + cloud lookups."""
    df = Dataflow("traffic")
    df.add_task("parse", "parse_xml")
    df.add_task("filter", "pi")            # map-matching / filtering analytics
    df.add_task("speed", "pi")             # average-speed analytics
    df.add_task("archive", "batch_file_write")
    df.add_task("lookup", "azure_table")
    df.add_task("model", "azure_blob")     # fetch road model
    df.add_task("agg", "batch_file_write")
    df.add_edge("parse", "filter")
    df.add_edge("parse", "archive")
    df.add_edge("filter", "speed")
    df.add_edge("filter", "lookup")
    df.add_edge("speed", "model")
    df.add_edge("lookup", "agg")
    df.add_edge("model", "agg")
    return _with_endpoints(df, heads=["parse"], tails=["agg", "archive"])


def finance_dag() -> Dataflow:
    """Fig. 6 Finance (bargain-index over stock trades, ~8 logic tasks),
    FP-heavy: parse, dedup, moving average, bargain index, persistence."""
    df = Dataflow("finance")
    df.add_task("parse", "parse_xml")
    df.add_task("dedup", "pi")
    df.add_task("vwap", "pi")              # volume-weighted average price
    df.add_task("mavg", "pi")              # moving average
    df.add_task("bargain", "pi")           # bargain index
    df.add_task("hist", "azure_table")     # historic quotes
    df.add_task("store", "batch_file_write")
    df.add_task("alert", "batch_file_write")
    df.add_edge("parse", "dedup")
    df.add_edge("dedup", "vwap")
    df.add_edge("dedup", "mavg")
    df.add_edge("vwap", "bargain")
    df.add_edge("mavg", "bargain")
    df.add_edge("bargain", "hist")
    df.add_edge("hist", "alert")
    df.add_edge("bargain", "store")
    return _with_endpoints(df, heads=["parse"], tails=["alert", "store"])


def grid_dag() -> Dataflow:
    """Fig. 6 Grid (smart-meter pre-processing + predictive analytics,
    ~15 logic tasks): parsing, DB ops, time-series analytics; the widest DAG
    with the highest fan-out (overall selectivity up to 1:4)."""
    df = Dataflow("grid")
    df.add_task("parse", "parse_xml")
    df.add_task("clean", "pi")
    df.add_task("meta", "azure_table")
    df.add_task("join", "pi")
    df.add_task("archive", "batch_file_write")
    df.add_task("interp", "pi")            # interpolation of gaps
    df.add_task("weather", "azure_blob")   # weather model download
    df.add_task("trend", "pi")             # time-series trend
    df.add_task("forecast", "pi")          # demand forecast
    df.add_task("baseline", "azure_table")
    df.add_task("compare", "pi")
    df.add_task("detect", "pi")            # anomaly detect
    df.add_task("notify", "batch_file_write")
    df.add_task("store", "azure_table")
    df.add_task("report", "batch_file_write")
    df.add_edge("parse", "clean")
    df.add_edge("parse", "archive")
    df.add_edge("clean", "meta")
    df.add_edge("clean", "interp")
    df.add_edge("meta", "join")
    df.add_edge("interp", "join")
    df.add_edge("join", "weather")
    df.add_edge("join", "trend")
    df.add_edge("weather", "forecast")
    df.add_edge("trend", "forecast")
    df.add_edge("forecast", "baseline")
    df.add_edge("baseline", "compare")
    df.add_edge("compare", "detect")
    df.add_edge("detect", "notify")
    df.add_edge("compare", "store")
    df.add_edge("detect", "report")
    return _with_endpoints(df, heads=["parse"], tails=["notify", "store", "report", "archive"])


MICRO_DAGS: Dict[str, Callable[[], Dataflow]] = {
    "linear": linear_dag,
    "diamond": diamond_dag,
    "star": star_dag,
}

APP_DAGS: Dict[str, Callable[[], Dataflow]] = {
    "traffic": traffic_dag,
    "finance": finance_dag,
    "grid": grid_dag,
}

ALL_DAGS: Dict[str, Callable[[], Dataflow]] = {**MICRO_DAGS, **APP_DAGS}
