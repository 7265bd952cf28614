"""Interprocedural analysis engine: call graph, locks, summaries.

Builds a whole-project view of the Python sources handed to
:func:`analyze_paths`:

* **modules** — each file parsed once (reusing the lint
  :class:`~repro_torch.analysis.lint._Module` for parent links and suppression
  comments), with its import table, classes, and lock definitions;
* **a call graph** — every call site resolved through local defs,
  module-level defs, ``from``-imports, module aliases, ``self.method``
  dispatch (with same-project base-class walk), class construction
  (→ ``__init__``) and local-variable provenance (``v = Cls(); v.m()``);
* **lock tracking** — ``threading.Lock``/``RLock`` objects bound at
  module level or as ``self.attr`` in a class body, and the ordered set
  of locks lexically held (via ``with``) at every call site and
  acquisition;
* **function summaries** (fixed point over the call graph) — which locks
  a function may acquire transitively, whether it may block
  (``join``/``get()``/``wait``/``sleep``/``result``/``recv``), and
  whether it constructs a ``jax.jit``/``vmap``/``pmap`` wrapper.

The analyzers that consume this live in :mod:`repro_torch.analysis.locks`
(RACE210–RACE212) and :mod:`repro_torch.analysis.jaxflow` (JAX110–JAX112);
:func:`analyze_paths` runs both and returns
:class:`~repro_torch.core.diagnostics.Violation` findings, honoring the same
``# lint: ok CODE - reason`` suppressions as the body-local lint.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.diagnostics import Severity, Violation

from .cfg import ReachingDefs
from .lint import KNOWN_CODES, _Module, iter_py_files

#: Attribute calls treated as potentially blocking when a lock is held.
#: ``get`` blocks only in its zero-positional-arg queue form —
#: ``d.get(key)`` is a dict lookup and is not counted.
BLOCKING_ATTRS = frozenset({"join", "result", "wait", "sleep", "recv"})

_FLOW_CODES = {"RACE210", "RACE211", "RACE212",
               "JAX110", "JAX111", "JAX112"}
assert _FLOW_CODES <= KNOWN_CODES, "flow codes must be suppressible"

_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass(frozen=True)
class LockDef:
    """One lock object the project may contend on."""
    key: str            # e.g. "repro_torch.core.simulator._KERNEL_LOCK"
    kind: str                   # "Lock" | "RLock"
    module: str
    line: int


@dataclasses.dataclass(frozen=True)
class Acquisition:
    """A ``with <lock>:`` entry inside one function."""
    lock: str
    line: int
    held: Tuple[str, ...]       # locks already held, outermost first


@dataclasses.dataclass(frozen=True)
class BlockingCall:
    """A direct potentially-blocking call (``x.join()``, ``q.get()``...)."""
    what: str
    line: int
    held: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class JitSite:
    """A ``jax.jit``/``vmap``/``pmap`` construction site."""
    kind: str
    line: int
    suppressed: bool            # carries a JAX101/JAX110 suppression
    node: ast.Call


@dataclasses.dataclass(frozen=True)
class CallSite:
    """A call resolved to a project function."""
    caller: str                 # fid of the calling function
    callee: str                 # fid of the resolved target
    line: int
    in_loop: bool               # lexically inside a loop of the caller
    held: Tuple[str, ...]       # locks held at the call
    via_method: bool            # resolved through obj.m() / self.m()
    node: ast.Call


class FunctionInfo:
    """Per-function facts harvested by one body walk."""

    def __init__(self, fid: str, module: "ModuleInfo",
                 node: ast.AST, qualname: str,
                 class_name: Optional[str]) -> None:
        self.fid = fid
        self.module = module
        self.node = node
        self.qualname = qualname
        self.class_name = class_name
        self.acquisitions: List[Acquisition] = []
        self.calls: List[CallSite] = []
        self.blocking: List[BlockingCall] = []
        self.jit_sites: List[JitSite] = []
        # parameter name -> line of a Python branch on its bare value
        self.param_branches: Dict[str, int] = {}
        # (inner def name, np local name, read line) when this function is
        # a factory returning a closure over an np-built local
        self.factory: Optional[Tuple[str, str, int]] = None
        self._rd: Optional[ReachingDefs] = None

    @property
    def params(self) -> Tuple[str, ...]:
        args = getattr(self.node, "args", None)
        if args is None:
            return ()
        names = [a.arg for a in args.posonlyargs + args.args]
        names.extend(a.arg for a in args.kwonlyargs)
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        return tuple(names)

    @property
    def positional(self) -> Tuple[str, ...]:
        args = getattr(self.node, "args", None)
        if args is None:
            return ()
        return tuple(a.arg for a in args.posonlyargs + args.args)

    def reaching(self) -> ReachingDefs:
        if self._rd is None:
            body = getattr(self.node, "body", [])
            self._rd = ReachingDefs(self.node, body, params=self.params)
        return self._rd

    @property
    def line(self) -> int:
        return getattr(self.node, "lineno", 0)


class ModuleInfo:
    """One parsed source file plus its name-resolution tables."""

    def __init__(self, filename: str, modname: str, mod: _Module) -> None:
        self.filename = filename
        self.name = modname
        self.mod = mod
        self.imports: Dict[str, str] = {}           # alias -> dotted module
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.functions: Dict[str, FunctionInfo] = {}    # qualname -> info
        self.class_bases: Dict[str, List[str]] = {}     # class -> base names
        self.module_locks: Dict[str, str] = {}          # name -> lock key
        self.class_locks: Dict[Tuple[str, str], str] = {}

    def suppressed(self, line: int, code: str) -> bool:
        return self.mod.suppressed(line, code)


def module_name_for(path: str) -> str:
    """Dotted module name: walk up while ``__init__.py`` marks a package."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    name = ".".join(reversed(parts))
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _resolve_relative(modname: str, node: ast.ImportFrom) -> Optional[str]:
    if node.level == 0:
        return node.module
    parts = modname.split(".")
    if len(parts) < node.level:
        return None
    base = parts[: len(parts) - node.level]
    if node.module:
        base.append(node.module)
    return ".".join(base) if base else None


def _lock_kind(value: ast.expr) -> Optional[str]:
    """``threading.Lock()``/``RLock()`` (or bare after from-import)."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if (isinstance(f, ast.Attribute) and f.attr in ("Lock", "RLock")
            and isinstance(f.value, ast.Name)
            and f.value.id == "threading"):
        return f.attr
    if isinstance(f, ast.Name) and f.id in ("Lock", "RLock"):
        return f.id
    return None


class Project:
    """Whole-program view over a set of Python files."""

    def __init__(self, files: Sequence[str]) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.functions: Dict[str, FunctionInfo] = {}
        self.locks: Dict[str, LockDef] = {}
        self.parse_errors: List[Violation] = []
        for fname in files:
            with open(fname, "r", encoding="utf-8") as fh:
                source = fh.read()
            try:
                mod = _Module(fname, source)
            except SyntaxError as err:
                self.parse_errors.append(Violation(
                    "LINT000", Severity.ERROR, fname,
                    f"{fname}:{err.lineno or 0}",
                    f"syntax error: {err.msg}"))
                continue
            modname = module_name_for(fname)
            self.modules[modname] = ModuleInfo(fname, modname, mod)
        for minfo in self.modules.values():
            self._collect_tables(minfo)
        for minfo in self.modules.values():
            self._collect_functions(minfo)
        for finfo in self.functions.values():
            self._scan_body(finfo)
        self._summarize()

    def lookup_module(self, dotted: Optional[str]) -> Optional[ModuleInfo]:
        """Find a module by dotted name, tolerating namespace-package
        prefixes (``repro_torch.core.x`` matches a module registered as
        ``core.x`` when ``repro`` has no ``__init__.py``)."""
        if not dotted:
            return None
        minfo = self.modules.get(dotted)
        if minfo is not None:
            return minfo
        for name, m in self.modules.items():
            if dotted.endswith("." + name) or name.endswith("." + dotted):
                return m
        return None

    # -- pass 1: imports, classes, locks ---------------------------------

    def _collect_tables(self, minfo: ModuleInfo) -> None:
        tree = minfo.mod.tree
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    minfo.imports[alias.asname or alias.name.split(".")[0]] \
                        = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    if alias.asname:
                        minfo.imports[alias.asname] = alias.name
            elif isinstance(node, ast.ImportFrom):
                src = _resolve_relative(minfo.name, node)
                if src is None:
                    continue
                for alias in node.names:
                    minfo.from_imports[alias.asname or alias.name] = \
                        (src, alias.name)
        for node in tree.body:
            if isinstance(node, ast.Assign):
                kind = _lock_kind(node.value)
                if kind:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            key = f"{minfo.name}.{tgt.id}"
                            minfo.module_locks[tgt.id] = key
                            self.locks[key] = LockDef(
                                key, kind, minfo.name, node.lineno)
            elif isinstance(node, ast.ClassDef):
                minfo.class_bases[node.name] = [
                    b.id for b in node.bases if isinstance(b, ast.Name)]
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Assign):
                        continue
                    kind = _lock_kind(sub.value)
                    if not kind:
                        continue
                    for tgt in sub.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            key = f"{minfo.name}.{node.name}.{tgt.attr}"
                            minfo.class_locks[(node.name, tgt.attr)] = key
                            self.locks[key] = LockDef(
                                key, kind, minfo.name, sub.lineno)

    # -- pass 2: function table ------------------------------------------

    def _collect_functions(self, minfo: ModuleInfo) -> None:
        def visit(node: ast.AST, prefix: str,
                  class_name: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FN_NODES):
                    qual = f"{prefix}{child.name}"
                    fid = f"{minfo.name}:{qual}"
                    finfo = FunctionInfo(fid, minfo, child, qual, class_name)
                    minfo.functions[qual] = finfo
                    self.functions[fid] = finfo
                    visit(child, f"{qual}.", None)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.", child.name)
                elif not isinstance(child, ast.Lambda):
                    visit(child, prefix, class_name)
        visit(minfo.mod.tree, "", None)

    # -- lock / call resolution ------------------------------------------

    def _resolve_lock(self, finfo: FunctionInfo,
                      expr: ast.expr) -> Optional[str]:
        minfo = finfo.module
        if isinstance(expr, ast.Name):
            key = minfo.module_locks.get(expr.id)
            if key:
                return key
            fi = minfo.from_imports.get(expr.id)
            if fi:
                src, orig = fi
                target = self.lookup_module(src)
                if target:
                    return target.module_locks.get(orig)
            return None
        if isinstance(expr, ast.Attribute):
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id in ("self", "cls")
                    and finfo.class_name):
                for cls in self._mro(minfo, finfo.class_name):
                    key = cls[0].class_locks.get((cls[1], expr.attr))
                    if key:
                        return key
                return None
            if isinstance(expr.value, ast.Name):
                target = self.lookup_module(minfo.imports.get(expr.value.id))
                if target:
                    return target.module_locks.get(expr.attr)
        return None

    def _mro(self, minfo: ModuleInfo,
             cls: str, depth: int = 0) -> List[Tuple[ModuleInfo, str]]:
        """Same-project linearization: the class then its bases."""
        if depth > 8 or cls not in minfo.class_bases:
            return []
        out = [(minfo, cls)]
        for base in minfo.class_bases[cls]:
            if base in minfo.class_bases:
                out.extend(self._mro(minfo, base, depth + 1))
            else:
                fi = minfo.from_imports.get(base)
                target = self.lookup_module(fi[0]) if fi else None
                if target is not None and fi is not None:
                    out.extend(self._mro(target, fi[1], depth + 1))
        return out

    def _class_fid(self, minfo: ModuleInfo, cls: str,
                   method: str) -> Optional[str]:
        for m, c in self._mro(minfo, cls):
            fi = m.functions.get(f"{c}.{method}")
            if fi:
                return fi.fid
        return None

    def _resolve_name(self, finfo: FunctionInfo,
                      name: str) -> Optional[str]:
        """Resolve a bare-name call: scopes out from the caller."""
        minfo = finfo.module
        scope = finfo.qualname
        while scope:
            fi = minfo.functions.get(f"{scope}.{name}")
            if fi:
                return fi.fid
            scope = scope.rpartition(".")[0]
        fi = minfo.functions.get(name)
        if fi:
            return fi.fid
        if name in minfo.class_bases:
            return self._class_fid(minfo, name, "__init__")
        imported = minfo.from_imports.get(name)
        if imported:
            src, orig = imported
            target = self.lookup_module(src)
            if target:
                fi = target.functions.get(orig)
                if fi:
                    return fi.fid
                if orig in target.class_bases:
                    return self._class_fid(target, orig, "__init__")
        return None

    def _class_of_expr(self, finfo: FunctionInfo,
                       expr: Optional[ast.expr]) \
            -> Optional[Tuple[ModuleInfo, str]]:
        """The project class ``expr`` constructs, if it is ``Cls(...)``."""
        if not isinstance(expr, ast.Call) or not isinstance(expr.func,
                                                            ast.Name):
            return None
        name = expr.func.id
        minfo = finfo.module
        if name in minfo.class_bases:
            return (minfo, name)
        imported = minfo.from_imports.get(name)
        if imported:
            target = self.lookup_module(imported[0])
            if target and imported[1] in target.class_bases:
                return (target, imported[1])
        return None

    def resolve_call(self, finfo: FunctionInfo,
                     node: ast.Call) -> Optional[Tuple[str, bool]]:
        """Resolve a call to (fid, via_method) or None if unknown."""
        func = node.func
        minfo = finfo.module
        if isinstance(func, ast.Name):
            fid = self._resolve_name(finfo, func.id)
            return (fid, False) if fid else None
        if isinstance(func, ast.Attribute) and isinstance(func.value,
                                                          ast.Name):
            base = func.value.id
            if base in ("self", "cls") and finfo.class_name:
                fid = self._class_fid(minfo, finfo.class_name, func.attr)
                return (fid, True) if fid else None
            target = self.lookup_module(minfo.imports.get(base))
            if target is not None:
                fi = target.functions.get(func.attr)
                if fi:
                    return (fi.fid, False)
            # local-variable provenance: v = Cls(...); v.m()
            for value in finfo.reaching().may_values(node, base):
                cls = self._class_of_expr(finfo, value)
                if cls:
                    fid = self._class_fid(cls[0], cls[1], func.attr)
                    if fid:
                        return (fid, True)
        return None

    # -- pass 3: body walk -----------------------------------------------

    def _scan_body(self, finfo: FunctionInfo) -> None:
        self._scan_stmts(finfo, getattr(finfo.node, "body", []),
                         held=(), in_loop=False)
        self._scan_param_branches(finfo)
        self._scan_factory(finfo)

    def _scan_stmts(self, finfo: FunctionInfo, stmts: Iterable[ast.stmt],
                    held: Tuple[str, ...], in_loop: bool) -> None:
        for stmt in stmts:
            self._scan_stmt(finfo, stmt, held, in_loop)

    def _scan_stmt(self, finfo: FunctionInfo, stmt: ast.stmt,
                   held: Tuple[str, ...], in_loop: bool) -> None:
        if isinstance(stmt, _FN_NODES + (ast.ClassDef,)):
            return                       # nested scope: its own FunctionInfo
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                self._scan_expr(finfo, item.context_expr, new_held, in_loop)
                lock = self._resolve_lock(finfo, item.context_expr)
                if lock:
                    finfo.acquisitions.append(Acquisition(
                        lock, stmt.lineno, new_held))
                    new_held = new_held + (lock,)
            self._scan_stmts(finfo, stmt.body, new_held, in_loop)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(finfo, stmt.iter, held, in_loop)
            self._scan_stmts(finfo, stmt.body, held, True)
            self._scan_stmts(finfo, stmt.orelse, held, in_loop)
            return
        if isinstance(stmt, ast.While):
            self._scan_expr(finfo, stmt.test, held, True)
            self._scan_stmts(finfo, stmt.body, held, True)
            self._scan_stmts(finfo, stmt.orelse, held, in_loop)
            return
        if isinstance(stmt, ast.If):
            self._scan_expr(finfo, stmt.test, held, in_loop)
            self._scan_stmts(finfo, stmt.body, held, in_loop)
            self._scan_stmts(finfo, stmt.orelse, held, in_loop)
            return
        if isinstance(stmt, ast.Try):
            self._scan_stmts(finfo, stmt.body, held, in_loop)
            for handler in stmt.handlers:
                self._scan_stmts(finfo, handler.body, held, in_loop)
            self._scan_stmts(finfo, stmt.orelse, held, in_loop)
            self._scan_stmts(finfo, stmt.finalbody, held, in_loop)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._scan_expr(finfo, child, held, in_loop)

    def _scan_expr(self, finfo: FunctionInfo, expr: ast.expr,
                   held: Tuple[str, ...], in_loop: bool) -> None:
        for node in ast.walk(expr):
            if isinstance(node, (ast.Lambda,) + _FN_NODES):
                continue
            if not isinstance(node, ast.Call):
                continue
            self._classify_call(finfo, node, held, in_loop)

    def _classify_call(self, finfo: FunctionInfo, node: ast.Call,
                       held: Tuple[str, ...], in_loop: bool) -> None:
        func = node.func
        minfo = finfo.module
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "jax"
                and func.attr in ("jit", "vmap", "pmap")):
            suppressed = (minfo.suppressed(node.lineno, "JAX101")
                          or minfo.suppressed(node.lineno, "JAX110"))
            finfo.jit_sites.append(JitSite(func.attr, node.lineno,
                                           suppressed, node))
            return
        resolved = self.resolve_call(finfo, node)
        if resolved:
            fid, via_method = resolved
            finfo.calls.append(CallSite(finfo.fid, fid, node.lineno,
                                        in_loop, held, via_method, node))
            return
        if isinstance(func, ast.Attribute):
            blocking = (func.attr in BLOCKING_ATTRS
                        or (func.attr == "get" and not node.args))
            if blocking:
                finfo.blocking.append(BlockingCall(
                    f".{func.attr}()", node.lineno, held))
            return
        if (isinstance(func, ast.Name)
                and finfo.module.from_imports.get(func.id) == ("time",
                                                               "sleep")):
            finfo.blocking.append(BlockingCall(
                "sleep()", node.lineno, held))

    def _scan_param_branches(self, finfo: FunctionInfo) -> None:
        """Branches on a parameter's bare (possibly traced) value."""
        params = set(finfo.params)
        if not params:
            return
        mod = finfo.module.mod
        for node in self._own_nodes(finfo):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            for name in ast.walk(node.test):
                if not (isinstance(name, ast.Name) and name.id in params):
                    continue
                parent = mod.parents.get(name)
                if isinstance(parent, ast.Attribute):
                    continue             # p.ndim / p.shape are concrete
                if (isinstance(parent, ast.Call)
                        and isinstance(parent.func, ast.Name)
                        and parent.func.id in ("isinstance", "len",
                                               "getattr", "hasattr")):
                    continue
                if isinstance(parent, ast.Compare) and all(
                        isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                        ast.NotIn))
                        for op in parent.ops):
                    continue             # identity/None checks are fine
                finfo.param_branches.setdefault(name.id, node.test.lineno)

    def _scan_factory(self, finfo: FunctionInfo) -> None:
        """Detect factories returning a closure over an np-built local."""
        np_locals: Dict[str, int] = {}
        inners: Dict[str, ast.AST] = {}
        returned: Set[str] = set()
        for node in self._own_nodes(finfo):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                root: ast.expr = node.value.func
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id == "np":
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            np_locals[tgt.id] = node.lineno
            elif isinstance(node, _FN_NODES):
                inners[node.name] = node
            elif isinstance(node, ast.Return) and isinstance(node.value,
                                                             ast.Name):
                returned.add(node.value.id)
        for name in returned & set(inners):
            inner = inners[name]
            args = getattr(inner, "args")
            params = {a.arg for a in args.posonlyargs + args.args
                      + args.kwonlyargs}
            for sub in ast.walk(inner):
                if (isinstance(sub, ast.Name) and sub.id in np_locals
                        and sub.id not in params
                        and isinstance(sub.ctx, ast.Load)):
                    finfo.factory = (name, sub.id, sub.lineno)
                    return

    def _own_nodes(self, finfo: FunctionInfo) -> Iterable[ast.AST]:
        """Walk the function body without crossing into nested scopes
        (nested defs themselves are yielded, their bodies are not)."""
        def walk(node: ast.AST) -> Iterable[ast.AST]:
            for child in ast.iter_child_nodes(node):
                yield child
                if isinstance(child, _FN_NODES + (ast.ClassDef,
                                                  ast.Lambda)):
                    continue
                yield from walk(child)
        yield from walk(finfo.node)

    # -- pass 4: fixed-point summaries -----------------------------------

    def _summarize(self) -> None:
        self.acquires: Dict[str, Set[str]] = {
            fid: {a.lock for a in fi.acquisitions}
            for fid, fi in self.functions.items()}
        self.blocks_witness: Dict[str, Tuple[int, str]] = {}
        self.constructs_witness: Dict[str, Tuple[int, str]] = {}
        for fid, fi in self.functions.items():
            for bc in fi.blocking:
                self.blocks_witness.setdefault(
                    fid, (bc.line, f"{bc.what} at "
                          f"{fi.module.filename}:{bc.line}"))
                break
            for js in fi.jit_sites:
                if not js.suppressed:
                    self.constructs_witness.setdefault(
                        fid, (js.line, f"jax.{js.kind} at "
                              f"{fi.module.filename}:{js.line}"))
                    break
        changed = True
        while changed:
            changed = False
            for fid, fi in self.functions.items():
                acq = self.acquires[fid]
                for cs in fi.calls:
                    callee_acq = self.acquires.get(cs.callee)
                    if callee_acq and not callee_acq <= acq:
                        acq |= callee_acq
                        changed = True
                    if (cs.callee in self.blocks_witness
                            and fid not in self.blocks_witness):
                        w = self.blocks_witness[cs.callee]
                        self.blocks_witness[fid] = (
                            cs.line, f"via {cs.callee} -> {w[1]}")
                        changed = True
                    if (cs.callee in self.constructs_witness
                            and fid not in self.constructs_witness):
                        w = self.constructs_witness[cs.callee]
                        self.constructs_witness[fid] = (
                            cs.line, f"via {cs.callee} -> {w[1]}")
                        changed = True


def analyze_project(project: Project,
                    *, include_suppressed: bool = False) -> List[Violation]:
    """Run every interprocedural analyzer over a built project."""
    from .jaxflow import check_jax_flow
    from .locks import check_locks
    out = list(project.parse_errors)
    out.extend(check_locks(project, include_suppressed=include_suppressed))
    out.extend(check_jax_flow(project,
                              include_suppressed=include_suppressed))
    return sorted(out, key=lambda v: (v.artifact, v.path, v.code))


def analyze_paths(paths: Sequence[str],
                  *, include_suppressed: bool = False) -> List[Violation]:
    """Build a project over ``paths`` and run the flow analyzers."""
    project = Project(iter_py_files(paths))
    return analyze_project(project, include_suppressed=include_suppressed)


#: (code, name, one-line summary) for every interprocedural rule — the
#: CLI's ``--list-rules`` and the SARIF rule table draw from this.
FLOW_RULES: List[Tuple[str, str, str]] = [
    ("LINT000", "syntax-error",
     "file failed to parse; the flow analyses did not run over it"),
    ("RACE210", "lock-order-cycle",
     "lock acquisition-order cycle across functions (potential ABBA "
     "deadlock); edges from with-nesting and call-graph closure"),
    ("RACE211", "blocking-while-locked",
     "blocking call (.join/.result/.wait/.get/sleep/recv) reachable while "
     "a lock is held — serialization or deadlock with the lock's owner"),
    ("RACE212", "reacquire-held-lock",
     "non-reentrant threading.Lock re-acquired (lexically or via a callee) "
     "while already held — self-deadlock"),
    ("JAX110", "jit-reached-from-loop",
     "call inside a loop reaches a jax.jit construction through helpers — "
     "retrace/recompile every iteration"),
    ("JAX111", "traced-arg-into-branch",
     "jnp-derived value passed to a callee that branches on that "
     "parameter with Python control flow — TracerBoolConversionError "
     "under jit"),
    ("JAX112", "jit-of-closure-factory",
     "jax.jit applied to a factory-made closure capturing a freshly "
     "computed array — the baked constant silently goes stale"),
]
