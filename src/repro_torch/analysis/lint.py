"""JAX-hazard and race-hazard codebase lint (stdlib ``ast`` only).

Walks Python sources flagging the two hazard families this repo has been
bitten by:

* **JAX recompile hazards** — patterns that defeat ``jax.jit``'s compile
  cache or silently bake Python values into traced code (the bug class
  the structural-signature kernel cache fixed);
* **race hazards** — shared mutable state reachable from concurrent
  callers without a lock.

Every rule is a :class:`Rule` whose docstring carries a *bad/good* pair
(mirrored in ``docs/INVARIANTS.md``).  Findings reuse the
:class:`~repro_torch.core.diagnostics.Violation` model with ``artifact`` =
file path and ``path`` = ``file:line``.

Suppression
-----------
A finding is suppressed by a trailing (or immediately preceding) comment
on its line naming the rule (or a comma-separated list of rules, or the
``*`` wildcard for every rule) with a reason::

    self._ops[key] = jax.jit(fn)   # lint: ok JAX101 - one-time init cache
    y = jax.jit(f)(x)              # lint: ok JAX101,JAX102 - one-shot tool
    z = risky()                    # lint: ok * - exhaustively reviewed

The reason text is required convention (the lint only checks the marker,
reviewers check the reason).  A suppression naming a code that no rule
owns (see :data:`KNOWN_CODES` — the lint rules plus the
:mod:`repro_torch.analysis.flow` interprocedural families) is reported as a
``LINT001`` WARNING instead of being silently ignored: dead suppressions
usually mean a typo that leaves the real finding live.  ``lint_paths``
reports unsuppressed findings only; the CLI exits non-zero when any
ERROR-severity finding remains.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.diagnostics import Severity, Violation

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ok\s+(\*|[A-Z]+\d+(?:\s*,\s*[A-Z]+\d+)*)")

#: Codes a suppression comment may legitimately name: the body-local lint
#: rules below plus the interprocedural families of
#: :mod:`repro_torch.analysis.flow` (lock-order RACE21x, cross-function
#: JAX11x).  ``repro_torch.analysis.flow`` asserts its analyzer codes stay a
#: subset.
KNOWN_CODES: Set[str] = {
    "JAX101", "JAX102", "JAX103", "JAX104", "RACE201", "RACE202",
    # .locks / .jaxflow (interprocedural)
    "RACE210", "RACE211", "RACE212", "JAX110", "JAX111", "JAX112",
}

#: Mutating method names on dict/list/set that count as writes.
_MUTATORS = {"append", "add", "update", "pop", "popitem", "setdefault",
             "clear", "extend", "remove", "insert", "discard"}


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    check: Callable[["_Module"], List[Tuple[int, str]]]
    doc: str


class _Module:
    """Parsed module plus the source-level context rules need."""

    def __init__(self, filename: str, source: str) -> None:
        self.filename = filename
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=filename)
        # ast.walk with parent links for loop-containment questions
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # suppression map: line -> codes named there ("*" = everything)
        self.suppress: Dict[int, Set[str]] = {}
        self.unknown_suppressions: List[Tuple[int, str]] = []
        for ln, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            codes = {c.strip() for c in m.group(1).split(",")}
            self.suppress[ln] = codes
            for c in sorted(codes):
                if c != "*" and c not in KNOWN_CODES:
                    self.unknown_suppressions.append((ln, c))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        while node in self.parents:
            node = self.parents[node]
            yield node

    def suppressed(self, line: int, code: str) -> bool:
        for ln in (line, line - 1):
            codes = self.suppress.get(ln)
            if codes and (code in codes or "*" in codes):
                return True
        return False


def _is_jax_attr(node: ast.AST, names: Sequence[str]) -> bool:
    """True for ``jax.<name>`` attribute accesses with ``name`` in names."""
    return (isinstance(node, ast.Attribute) and node.attr in names
            and isinstance(node.value, ast.Name) and node.value.id == "jax")


def _mentions_jnp(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "jnp"
               for n in ast.walk(node))


# ---------------------------------------------------------------------------
# JAX recompile hazards.
# ---------------------------------------------------------------------------

def _jax101(mod: _Module) -> List[Tuple[int, str]]:
    """JAX101 — jit/vmap/pmap constructed inside a loop body.

    Every ``jax.jit(f)`` call returns a FRESH callable with its own compile
    cache; constructing one per loop iteration recompiles per iteration.

    bad::

        for x in batches:
            y = jax.jit(step)(x)        # retraces every iteration

    good::

        step_c = jax.jit(step)          # once, outside the loop
        for x in batches:
            y = step_c(x)

    Building a *persistent* cache in a one-time setup loop is legitimate —
    suppress with a reason (see ``runtime/executor.py``)."""
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and \
                _is_jax_attr(node.func, ("jit", "vmap", "pmap")):
            for anc in mod.ancestors(node):
                if isinstance(anc, (ast.For, ast.While, ast.AsyncFor)):
                    # the loop's own iterable/test is evaluated once
                    out.append((node.lineno,
                                f"jax.{node.func.attr} constructed inside a "
                                f"loop (line {anc.lineno}): a fresh callable "
                                "per iteration defeats the compile cache"))
                    break
                if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    break   # a nested def inside a loop runs once per call
    return out


def _jax102(mod: _Module) -> List[Tuple[int, str]]:
    """JAX102 — inline ``jax.jit(f)(args)``: construct-and-call.

    The jitted wrapper is thrown away after one call, so its compile cache
    dies with it — every execution retraces.

    bad::

        result = jax.jit(loss_fn)(params, batch)

    good::

        loss_c = jax.jit(loss_fn)       # kept; cache lives across calls
        result = loss_c(params, batch)

    (``jax.vmap`` has no compile cache of its own, so inline vmap under an
    enclosing jit is fine and not flagged.)"""
    out = []
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)
                and _is_jax_attr(node.func.func, ("jit",))):
            out.append((node.lineno,
                        "jax.jit(f)(...) constructs and discards the jitted "
                        "callable per call — hoist the jit"))
    return out


def _jax103(mod: _Module) -> List[Tuple[int, str]]:
    """JAX103 — Python branch on a traced value.

    ``if``/``while`` force a concrete bool; inside jit that raises a
    TracerBoolConversionError, outside it silently bakes one execution's
    data into control flow.

    bad::

        if jnp.any(queues > 0):         # concretizes a traced array
            drain()

    good::

        jax.lax.cond(jnp.any(queues > 0), drain, skip, state)
    """
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.If, ast.While)) and _mentions_jnp(node.test):
            out.append((node.test.lineno,
                        "Python if/while on a jnp expression branches on a "
                        "traced value — use lax.cond/lax.while_loop or "
                        "np.* on concrete data"))
    return out


def _jax104(mod: _Module) -> List[Tuple[int, str]]:
    """JAX104 — numpy closure constant baked into a jit-returned kernel.

    A factory that builds an ``np.*`` array and returns ``jax.jit(inner)``
    bakes that array into the traced graph as a CONSTANT: two factory
    calls with different arrays are two different compiled programs even
    when shapes match — the exact recompile class the scan-kernel cache
    fixed by keying kernels on structure and passing placement data as
    operands.

    bad::

        def make_kernel(placement):
            frac = np.asarray(placement)     # data, not structure
            def kernel(x):
                return x * jnp.asarray(frac)  # baked constant -> retrace
            return jax.jit(kernel)

    good::

        def make_kernel():
            def kernel(x, frac):              # operand: traced, shared
                return x * frac
            return jax.jit(kernel)

    Arrays that are part of the factory's cache key (structural constants)
    are legitimate — suppress with a reason (see
    ``core/simulator.py::_make_scan_kernel``)."""
    out = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # locals assigned from np.<...>(...) in this function's own body
        np_locals: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                f = node.value.func
                root = f
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id == "np":
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            np_locals.add(tgt.id)
        if not np_locals:
            continue
        # nested defs handed to jax.jit(...) anywhere inside this function
        jitted: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and _is_jax_attr(node.func,
                                                           ("jit",)):
                if node.args and isinstance(node.args[0], ast.Name):
                    jitted.add(node.args[0].id)
        if not jitted:
            continue
        inners = [n for n in ast.walk(fn)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not fn and n.name in jitted]
        for inner in inners:
            params = {a.arg for a in inner.args.args + inner.args.kwonlyargs}
            for node in ast.walk(inner):
                if (isinstance(node, ast.Name) and node.id in np_locals
                        and node.id not in params
                        and isinstance(node.ctx, ast.Load)):
                    out.append((node.lineno,
                                f"np-built closure {node.id!r} read inside "
                                f"jitted {inner.name!r}: baked as a compile-"
                                "time constant — pass it as an operand or "
                                "key the factory's cache on it"))
    return out


# ---------------------------------------------------------------------------
# Race hazards.
# ---------------------------------------------------------------------------

def _module_level_mutables(mod: _Module) -> Set[str]:
    muts: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            v = node.value
            mutable = isinstance(v, (ast.Dict, ast.List, ast.Set)) or (
                isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id in ("dict", "list", "set", "defaultdict",
                                  "OrderedDict", "Counter", "deque"))
            if mutable:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        muts.add(tgt.id)
    return muts


def _module_level_locks(mod: _Module) -> Set[str]:
    locks: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            f = node.value.func
            if (isinstance(f, ast.Attribute) and f.attr in ("Lock", "RLock")
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "threading"):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        locks.add(tgt.id)
    return locks


def _race201(mod: _Module) -> List[Tuple[int, str]]:
    """RACE201 — module-level mutable cache mutated without a lock.

    Module globals are shared by every thread; get-then-set on them races
    (lost updates, torn stats).  The repo's fixed exemplar is
    ``core/simulator.py::get_scan_kernel``: its compiled-kernel cache and
    hit/miss counters (``_KERNEL_CACHE``/``_KERNEL_STATS``) are now
    mutated only under the module-level ``_KERNEL_LOCK``.

    bad::

        _CACHE = {}
        def get(key):
            if key not in _CACHE:        # check-then-act race
                _CACHE[key] = build(key)
            return _CACHE[key]

    good::

        _CACHE = {}
        _LOCK = threading.Lock()
        def get(key):
            with _LOCK:
                if key not in _CACHE:
                    _CACHE[key] = build(key)
                return _CACHE[key]
    """
    muts = _module_level_mutables(mod)
    locks = _module_level_locks(mod)
    if not muts:
        return []
    out = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        shadowed = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        for node in ast.walk(fn):
            name: Optional[str] = None
            what = ""
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
                targets = (node.targets if isinstance(node, (ast.Assign,
                                                             ast.Delete))
                           else [node.target])
                for tgt in targets:
                    if (isinstance(tgt, ast.Subscript)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id in muts
                            and tgt.value.id not in shadowed):
                        name, what = tgt.value.id, "subscript write"
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MUTATORS
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id in muts
                  and node.func.value.id not in shadowed):
                name, what = node.func.value.id, f".{node.func.attr}()"
            if name is None:
                continue
            held = any(
                isinstance(anc, ast.With) and any(
                    isinstance(item.context_expr, ast.Name)
                    and item.context_expr.id in locks
                    for item in anc.items)
                for anc in mod.ancestors(node))
            if not held:
                out.append((node.lineno,
                            f"module-level mutable {name!r} mutated "
                            f"({what}) outside a module-level "
                            "threading.Lock"))
    return out


def _race202(mod: _Module) -> List[Tuple[int, str]]:
    """RACE202 — mutable default argument.

    A ``def f(x, acc=[])`` default is ONE object shared by every call (and
    every thread) for the life of the process — classic cross-call state
    leak that reads like a local.

    bad::

        def collect(x, acc=[]):
            acc.append(x)
            return acc

    good::

        def collect(x, acc=None):
            acc = [] if acc is None else acc
            acc.append(x)
            return acc
    """
    out = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            continue
        for default in list(fn.args.defaults) + \
                [d for d in fn.args.kw_defaults if d is not None]:
            bad = isinstance(default, (ast.Dict, ast.List, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in ("dict", "list", "set", "defaultdict"))
            if bad:
                label = getattr(fn, "name", "<lambda>")
                out.append((default.lineno,
                            f"mutable default argument in {label!r} is "
                            "shared across all calls — default to None"))
    return out


RULES: List[Rule] = [
    Rule("JAX101", "jit-in-loop", _jax101, _jax101.__doc__ or ""),
    Rule("JAX102", "inline-jit-call", _jax102, _jax102.__doc__ or ""),
    Rule("JAX103", "traced-branch", _jax103, _jax103.__doc__ or ""),
    Rule("JAX104", "baked-closure-constant", _jax104, _jax104.__doc__ or ""),
    Rule("RACE201", "unlocked-module-cache", _race201, _race201.__doc__ or ""),
    Rule("RACE202", "mutable-default-arg", _race202, _race202.__doc__ or ""),
]


def lint_source(source: str, filename: str = "<string>",
                *, include_suppressed: bool = False) -> List[Violation]:
    """Lint one source text; returns unsuppressed findings (all rules)."""
    try:
        mod = _Module(filename, source)
    except SyntaxError as err:
        return [Violation("LINT000", Severity.ERROR, filename,
                          f"{filename}:{err.lineno or 0}",
                          f"syntax error: {err.msg}")]
    out: List[Violation] = []
    for rule in RULES:
        for line, detail in rule.check(mod):
            if include_suppressed or not mod.suppressed(line, rule.code):
                out.append(Violation(rule.code, Severity.ERROR, filename,
                                     f"{filename}:{line}", detail))
    for line, code in mod.unknown_suppressions:
        out.append(Violation("LINT001", Severity.WARNING, filename,
                             f"{filename}:{line}",
                             f"suppression names unknown code {code!r} — "
                             "typo? the finding it meant to silence (if any) "
                             "is still reported"))
    return sorted(out, key=lambda v: (v.artifact, v.path, v.code))


def iter_py_files(paths: Sequence[str]) -> List[str]:
    """Every ``.py`` under ``paths``.  Walks skip ``fixtures`` subtrees —
    those hold deliberately-buggy exemplars (``tests/fixtures/flow``) that
    must not fail a whole-tree lint; point at the directory or file
    explicitly to analyze them."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git",
                                              "fixtures"))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


def lint_paths(paths: Sequence[str],
               *, include_suppressed: bool = False) -> List[Violation]:
    """Lint every ``.py`` under ``paths`` (files or directories)."""
    out: List[Violation] = []
    for f in iter_py_files(paths):
        with open(f, "r", encoding="utf-8") as fh:
            out.extend(lint_source(fh.read(), f,
                                   include_suppressed=include_suppressed))
    return out
