"""Lock-order / deadlock analyzers over the interprocedural engine.

Three rules, all ERROR severity, all suppressible at the reported line
with a ``lint: ok RACE21x - reason`` comment:

* **RACE210 — lock-order cycle.**  Build the lock-acquisition-order
  graph: an edge ``A -> B`` means some code path acquires ``B`` while
  holding ``A`` (lexically via nested ``with``, or by calling a function
  that transitively acquires ``B``).  Any cycle is a potential ABBA
  deadlock: two threads entering the cycle from different locks wait on
  each other forever.

  bad::

      def f():               # thread 1
          with LOCK_A:
              with LOCK_B: ...
      def g():               # thread 2
          with LOCK_B:
              with LOCK_A: ...

  good: every code path acquires locks in one global order (A before B).

* **RACE211 — blocking call while holding a lock.**  ``join``/``get()``/
  ``wait``/``sleep``/``result``/``recv`` under a held lock stalls every
  other thread contending on it — and deadlocks outright when the
  joined thread needs that lock to finish.

  bad::

      with self._lock:
          self._worker.join()      # worker may need _lock to exit

  good (hand-over-hand)::

      with self._lock:
          worker, self._worker = self._worker, None
      worker.join()                # blocking call outside the lock

* **RACE212 — re-acquiring a held non-reentrant lock.**  Acquiring a
  ``threading.Lock`` (not ``RLock``) the current thread already holds —
  directly or by calling a function that acquires it — self-deadlocks.

  bad::

      def flush(self):
          with self._lock:
              self.reset()         # reset() takes self._lock again

  good: split a ``_reset_locked()`` body out and call it from both.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.diagnostics import Severity, Violation

from .flow import Project

#: Edge witness: (filename, line, description).
_Witness = Tuple[str, int, str]


def lock_order_edges(project: Project) -> Dict[Tuple[str, str], _Witness]:
    """``(held, acquired)`` pairs with one witness site each."""
    edges: Dict[Tuple[str, str], _Witness] = {}
    for fi in project.functions.values():
        fname = fi.module.filename
        for acq in fi.acquisitions:
            for h in acq.held:
                if h != acq.lock:
                    edges.setdefault((h, acq.lock), (
                        fname, acq.line,
                        f"{fi.fid} acquires {acq.lock} while holding {h}"))
        for cs in fi.calls:
            callee_acq = project.acquires.get(cs.callee, set())
            for h in cs.held:
                for lock in sorted(callee_acq):
                    if lock != h:
                        edges.setdefault((h, lock), (
                            fname, cs.line,
                            f"{fi.fid} holds {h} and calls {cs.callee} "
                            f"which acquires {lock}"))
    return edges


def _sccs(nodes: List[str],
          succ: Dict[str, List[str]]) -> List[List[str]]:
    """Tarjan strongly-connected components (iterative)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack[node] = True
            recursed = False
            children = succ.get(node, [])
            for i in range(pi, len(children)):
                child = children[i]
                if child not in index:
                    work[-1] = (node, i + 1)
                    work.append((child, 0))
                    recursed = True
                    break
                if on_stack.get(child):
                    low[node] = min(low[node], index[child])
            if recursed:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)

    for n in nodes:
        if n not in index:
            strongconnect(n)
    return out


def check_locks(project: Project,
                *, include_suppressed: bool = False) -> List[Violation]:
    out: List[Violation] = []

    def emit(code: str, minfo_file: str, line: int, detail: str,
             module: "object") -> None:
        suppressed = getattr(module, "suppressed")(line, code)
        if include_suppressed or not suppressed:
            out.append(Violation(code, Severity.ERROR, minfo_file,
                                 f"{minfo_file}:{line}", detail))

    # RACE210: cycles in the acquisition-order graph
    edges = lock_order_edges(project)
    succ: Dict[str, List[str]] = {}
    for (a, b) in edges:
        succ.setdefault(a, []).append(b)
    nodes = sorted({n for e in edges for n in e})
    for comp in _sccs(nodes, succ):
        if len(comp) < 2:
            continue
        comp_set = set(comp)
        cycle_edges = sorted((a, b) for (a, b) in edges
                             if a in comp_set and b in comp_set)
        fname, line, _ = edges[cycle_edges[0]]
        minfo = _module_for(project, fname)
        detail = ("lock-order cycle between "
                  + ", ".join(sorted(comp)) + ": "
                  + "; ".join(edges[e][2] for e in cycle_edges))
        emit("RACE210", fname, line, detail, minfo)

    for fi in project.functions.values():
        fname = fi.module.filename
        # RACE211: blocking while holding a lock
        for bc in fi.blocking:
            if bc.held:
                emit("RACE211", fname, bc.line,
                     f"{fi.fid} makes blocking call {bc.what} while "
                     f"holding {', '.join(bc.held)} — move the blocking "
                     "call outside the lock (hand-over-hand)",
                     fi.module)
        for cs in fi.calls:
            if cs.held and cs.callee in project.blocks_witness:
                _, wdesc = project.blocks_witness[cs.callee]
                emit("RACE211", fname, cs.line,
                     f"{fi.fid} holds {', '.join(cs.held)} across call to "
                     f"{cs.callee}, which may block ({wdesc})",
                     fi.module)
        # RACE212: re-acquiring a held non-reentrant lock
        for acq in fi.acquisitions:
            if (acq.lock in acq.held
                    and project.locks[acq.lock].kind == "Lock"):
                emit("RACE212", fname, acq.line,
                     f"{fi.fid} re-acquires non-reentrant {acq.lock} "
                     "already held on this path — self-deadlock",
                     fi.module)
        for cs in fi.calls:
            callee_acq = project.acquires.get(cs.callee, set())
            for h in cs.held:
                if h in callee_acq and project.locks[h].kind == "Lock":
                    emit("RACE212", fname, cs.line,
                         f"{fi.fid} holds non-reentrant {h} and calls "
                         f"{cs.callee} which (transitively) acquires it "
                         "— self-deadlock",
                         fi.module)
    return out


def _module_for(project: Project, filename: str) -> "object":
    for minfo in project.modules.values():
        if minfo.filename == filename:
            return minfo
    raise KeyError(filename)
