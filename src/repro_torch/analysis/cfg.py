"""Per-function control-flow graphs and reaching-definitions data flow.

The interprocedural engine (:mod:`repro_torch.analysis.flow`) needs two local
facts about a function body:

* a **control-flow graph** — basic blocks of statements linked by
  successor edges, with loops/branches/try lowered the standard way;
* **reaching definitions** over that CFG — for a variable use, which
  assignments *may* have produced its value (value provenance).

Both are deliberately small: statement-granular blocks, a monotone
union/worklist solve, and a query API (:meth:`ReachingDefs.may_values`)
that returns the *value expressions* of the reaching assignments so
analyzers can pattern-match provenance (e.g. "was this name possibly
bound to a ``jnp`` expression?" for JAX111, "was it bound to a call of
factory ``F`` ?" for JAX112).

Nested function/class bodies are opaque: a nested ``def`` is a single
definition event of its name; its body belongs to its own CFG.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

#: A definition event: (names defined, value expression or None=unknown).
_Defs = List[Tuple[str, Optional[ast.expr]]]

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def _walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node``'s subtree without descending into nested scopes."""
    yield node
    if isinstance(node, _SCOPE_NODES):
        return
    for child in ast.iter_child_nodes(node):
        yield from _walk_same_scope(child)


def _target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_target_names(elt))
        return out
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []          # attribute / subscript targets are not local names


def _event_defs(node: ast.AST) -> _Defs:
    """Names defined by one CFG event, with their value expression."""
    defs: _Defs = []
    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            names = _target_names(tgt)
            # a tuple unpack loses the per-name expression: keep the RHS
            # only for the single-name form where it IS the value
            value = node.value if isinstance(tgt, ast.Name) else None
            defs.extend((n, value) for n in names)
    elif isinstance(node, ast.AnnAssign):
        if isinstance(node.target, ast.Name) and node.value is not None:
            defs.append((node.target.id, node.value))
    elif isinstance(node, ast.AugAssign):
        defs.extend((n, None) for n in _target_names(node.target))
    elif isinstance(node, ast.For):
        defs.extend((n, None) for n in _target_names(node.target))
    elif isinstance(node, ast.withitem):
        if node.optional_vars is not None:
            defs.extend((n, node.context_expr)
                        for n in _target_names(node.optional_vars))
    elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
        defs.append((node.name, None))
    elif isinstance(node, ast.Import):
        for alias in node.names:
            defs.append(((alias.asname or alias.name).split(".")[0], None))
    elif isinstance(node, ast.ImportFrom):
        for alias in node.names:
            defs.append((alias.asname or alias.name, None))
    elif isinstance(node, ast.ExceptHandler):
        if node.name:
            defs.append((node.name, None))
    elif isinstance(node, ast.NamedExpr):
        if isinstance(node.target, ast.Name):
            defs.append((node.target.id, node.value))
    return defs


class BasicBlock:
    """A straight-line run of definition/use events."""

    __slots__ = ("bid", "events", "succ")

    def __init__(self, bid: int) -> None:
        self.bid = bid
        self.events: List[ast.AST] = []
        self.succ: List["BasicBlock"] = []

    def link(self, other: "BasicBlock") -> None:
        if other not in self.succ:
            self.succ.append(other)

    def __repr__(self) -> str:   # pragma: no cover - debug aid
        return (f"B{self.bid}({len(self.events)} ev -> "
                f"{[b.bid for b in self.succ]})")


class CFG:
    """Control-flow graph of one function body (statement granularity)."""

    def __init__(self, fn: ast.AST, body: List[ast.stmt]) -> None:
        self.fn = fn
        self.blocks: List[BasicBlock] = []
        self.entry = self._new()
        self.exit = self._new()
        # (head, after) per enclosing loop, innermost last
        self._loops: List[Tuple[BasicBlock, BasicBlock]] = []
        end = self._visit_body(body, self.entry)
        if end is not None:
            end.link(self.exit)

    def _new(self) -> BasicBlock:
        b = BasicBlock(len(self.blocks))
        self.blocks.append(b)
        return b

    def _visit_body(self, stmts: List[ast.stmt],
                    cur: Optional[BasicBlock]) -> Optional[BasicBlock]:
        for stmt in stmts:
            if cur is None:          # unreachable code: isolated block
                cur = self._new()
            cur = self._visit(stmt, cur)
        return cur

    def _visit(self, stmt: ast.stmt,
               cur: BasicBlock) -> Optional[BasicBlock]:
        if isinstance(stmt, (ast.Return, ast.Raise)):
            cur.events.append(stmt)
            cur.link(self.exit)
            return None
        if isinstance(stmt, ast.Break):
            if self._loops:
                cur.link(self._loops[-1][1])
            return None
        if isinstance(stmt, ast.Continue):
            if self._loops:
                cur.link(self._loops[-1][0])
            return None
        if isinstance(stmt, ast.If):
            cur.events.append(stmt.test)
            then = self._new()
            cur.link(then)
            end_then = self._visit_body(stmt.body, then)
            join = self._new()
            if stmt.orelse:
                other = self._new()
                cur.link(other)
                end_other = self._visit_body(stmt.orelse, other)
                if end_other is not None:
                    end_other.link(join)
            else:
                cur.link(join)
            if end_then is not None:
                end_then.link(join)
            return join
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            head = self._new()
            cur.link(head)
            if isinstance(stmt, ast.While):
                head.events.append(stmt.test)
            else:
                head.events.append(stmt)      # For defines its target
            after = self._new()
            body = self._new()
            head.link(body)
            self._loops.append((head, after))
            end = self._visit_body(stmt.body, body)
            self._loops.pop()
            if end is not None:
                end.link(head)
            if stmt.orelse:                   # runs on normal loop exit
                or_start = self._new()
                head.link(or_start)
                end_or = self._visit_body(stmt.orelse, or_start)
                if end_or is not None:
                    end_or.link(after)
            else:
                head.link(after)              # zero-iteration path
            return after
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                cur.events.append(item)
            return self._visit_body(stmt.body, cur)
        if isinstance(stmt, ast.Try):
            end_body = self._visit_body(stmt.body, cur)
            tails: List[BasicBlock] = []
            for handler in stmt.handlers:
                hb = self._new()
                cur.link(hb)                  # any stmt in body may raise
                hb.events.append(handler)
                end_h = self._visit_body(handler.body, hb)
                if end_h is not None:
                    tails.append(end_h)
            if stmt.orelse and end_body is not None:
                end_body = self._visit_body(stmt.orelse, end_body)
            if end_body is not None:
                tails.append(end_body)
            join: Optional[BasicBlock]
            if stmt.finalbody:
                join = self._new()
                for t in tails:
                    t.link(join)
                return self._visit_body(stmt.finalbody, join)
            if not tails:
                return None
            join = self._new()
            for t in tails:
                t.link(join)
            return join
        # simple statement (incl. nested defs, which define their name)
        cur.events.append(stmt)
        return cur


class ReachingDefs:
    """May-reaching definitions over a :class:`CFG`, with value queries."""

    def __init__(self, fn: ast.AST, body: List[ast.stmt],
                 params: Tuple[str, ...] = ()) -> None:
        self.cfg = CFG(fn, body)
        # def site -> (block id, event index); values indexed the same way
        self._values: Dict[Tuple[int, int, str],
                           Optional[ast.expr]] = {}
        self._where: Dict[int, Tuple[int, int]] = {}     # id(node) -> site
        gen: Dict[int, Dict[str, Set[Tuple[int, int]]]] = {}
        for block in self.cfg.blocks:
            g: Dict[str, Set[Tuple[int, int]]] = {}
            for idx, ev in enumerate(block.events):
                for name, value in _event_defs(ev):
                    g[name] = {(block.bid, idx)}
                    self._values[(block.bid, idx, name)] = value
                for sub in _walk_same_scope(ev):
                    self._where.setdefault(id(sub), (block.bid, idx))
            gen[block.bid] = g
        entry_defs: Dict[str, Set[Tuple[int, int]]] = {
            p: {(-1, -1)} for p in params}
        for p in params:
            self._values[(-1, -1, p)] = None
        # worklist solve: IN[b] = union OUT[preds]; OUT = gen over IN
        self._in: Dict[int, Dict[str, Set[Tuple[int, int]]]] = {
            b.bid: {} for b in self.cfg.blocks}
        self._in[self.cfg.entry.bid] = dict(entry_defs)
        out: Dict[int, Dict[str, Set[Tuple[int, int]]]] = {}
        work = [b.bid for b in self.cfg.blocks]
        by_id = {b.bid: b for b in self.cfg.blocks}
        while work:
            bid = work.pop()
            block = by_id[bid]
            o = dict(self._in[bid])
            for name, sites in gen[bid].items():
                o[name] = set(sites)
            if out.get(bid) == o:
                continue
            out[bid] = o
            for succ in block.succ:
                tgt = self._in[succ.bid]
                changed = False
                for name, sites in o.items():
                    have = tgt.setdefault(name, set())
                    if not sites <= have:
                        have.update(sites)
                        changed = True
                if changed and succ.bid not in work:
                    work.append(succ.bid)

    def may_values(self, use: ast.AST, name: str) -> List[Optional[ast.expr]]:
        """Value expressions ``name`` may hold at ``use`` (None=opaque).

        Returns ``[]`` when the name has no local definition reaching the
        use (a global, builtin, or free variable).
        """
        site = self._where.get(id(use))
        if site is None:
            return []
        bid, idx = site
        block = self.cfg.blocks[bid]
        sites = set(self._in[bid].get(name, set()))
        for i in range(idx):                 # earlier events in the block
            for n, _ in _event_defs(block.events[i]):
                if n == name:
                    sites = {(bid, i)}
        out: List[Optional[ast.expr]] = []
        for s in sorted(sites):
            out.append(self._values.get((s[0], s[1], name)))
        return out
