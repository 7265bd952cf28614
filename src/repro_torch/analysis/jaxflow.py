"""Cross-function JAX hazards over the interprocedural engine.

The body-local lint (JAX101–JAX104) catches hazards visible inside one
function.  These three see *across* call boundaries — all ERROR
severity, suppressible with a ``lint: ok JAX11x - reason`` comment:

* **JAX110 — loop reaches a jit construction through a call chain.**
  ``jax.jit(f)`` in a loop body is JAX101; hiding the construction one
  call away defeats that check but not this one.

  bad::

      def make_step():
          return jax.jit(step)
      for batch in data:
          y = make_step()(batch)      # fresh compile cache per iteration

  good: hoist the ``make_step()`` call out of the loop, or key the
  construction on a persistent cache and suppress *at the construction
  site* (``# lint: ok JAX110 - keyed cache``, which also stops the
  propagation — see ``core/simulator.py``).

* **JAX111 — traced value flows into a Python branch in a callee.**
  The callee's ``if p:`` looks innocent until a caller passes a traced
  array for ``p``.

  bad::

      def clamp(x, lo):
          if lo:                      # concretizes when lo is traced
              return jnp.maximum(x, lo)
          return x
      y = clamp(jnp.abs(v), jnp.min(v))

  good: branch with ``lax.cond``/``jnp.where`` in the callee, or pass
  concrete Python/np scalars.

* **JAX112 — np closure constant jitted by the caller.**  JAX104's
  factory pattern, split across functions: the factory returns the
  closure un-jitted and the *caller* jits it, baking the factory's
  ``np.*`` local in as a compile-time constant.

  bad::

      def make_kernel(placement):
          frac = np.asarray(placement)
          def kernel(x):
              return x * jnp.asarray(frac)   # closure constant
          return kernel
      step = jax.jit(make_kernel(p))         # caller bakes `frac` in

  good: pass the array as an operand, or key the factory's cache on it
  and suppress at the jit site with a reason.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..core.diagnostics import Severity, Violation

from .flow import CallSite, FunctionInfo, Project
from .lint import _mentions_jnp


def _maybe_jnp(finfo: FunctionInfo, expr: ast.expr) -> bool:
    """Does ``expr`` mention jnp, directly or through reaching defs?"""
    if _mentions_jnp(expr):
        return True
    if isinstance(expr, ast.Name):
        for value in finfo.reaching().may_values(expr, expr.id):
            if value is not None and _mentions_jnp(value):
                return True
    return False


def _arg_for_param(cs: CallSite, callee: FunctionInfo,
                   param: str) -> Optional[ast.expr]:
    """The caller expression bound to ``param`` at this call site."""
    for kw in cs.node.keywords:
        if kw.arg == param:
            return kw.value
    positional = list(callee.positional)
    if cs.via_method and positional and positional[0] in ("self", "cls"):
        positional = positional[1:]
    try:
        idx = positional.index(param)
    except ValueError:
        return None
    if idx < len(cs.node.args):
        arg = cs.node.args[idx]
        return None if isinstance(arg, ast.Starred) else arg
    return None


def check_jax_flow(project: Project,
                   *, include_suppressed: bool = False) -> List[Violation]:
    out: List[Violation] = []

    def emit(fi: FunctionInfo, code: str, line: int, detail: str) -> None:
        fname = fi.module.filename
        if include_suppressed or not fi.module.suppressed(line, code):
            out.append(Violation(code, Severity.ERROR, fname,
                                 f"{fname}:{line}", detail))

    for fi in project.functions.values():
        for cs in fi.calls:
            # JAX110: in-loop call reaching a jit construction
            if cs.in_loop and cs.callee in project.constructs_witness:
                _, wdesc = project.constructs_witness[cs.callee]
                emit(fi, "JAX110", cs.line,
                     f"call to {cs.callee} inside a loop reaches a jax "
                     f"wrapper construction ({wdesc}) — a fresh compile "
                     "cache per iteration; hoist the construction or key "
                     "it on a persistent cache")
            # JAX111: traced argument meets a Python branch in the callee
            callee = project.functions.get(cs.callee)
            if callee is None:
                continue
            for param, branch_line in sorted(callee.param_branches.items()):
                arg = _arg_for_param(cs, callee, param)
                if arg is not None and _maybe_jnp(fi, arg):
                    emit(fi, "JAX111", cs.line,
                         f"possibly-traced (jnp) argument for {param!r} "
                         f"of {cs.callee}, which branches on it at "
                         f"{callee.module.filename}:{branch_line} — "
                         "concretizes a tracer; use lax.cond/jnp.where "
                         "in the callee or pass a concrete value")
        # JAX112: caller jits a factory-made closure over an np local
        for js in fi.jit_sites:
            if js.kind != "jit" or not js.node.args:
                continue
            target = js.node.args[0]
            factory_fids: List[str] = []
            if isinstance(target, ast.Call):
                resolved = project.resolve_call(fi, target)
                if resolved:
                    factory_fids.append(resolved[0])
            elif isinstance(target, ast.Name):
                for value in fi.reaching().may_values(target, target.id):
                    if isinstance(value, ast.Call):
                        resolved = project.resolve_call(fi, value)
                        if resolved:
                            factory_fids.append(resolved[0])
            for fid in factory_fids:
                factory = project.functions.get(fid)
                if factory is None or factory.factory is None:
                    continue
                inner, np_name, read_line = factory.factory
                emit(fi, "JAX112", js.line,
                     f"jax.jit of {fid}'s returned closure {inner!r}, "
                     f"which reads np-built {np_name!r} "
                     f"({factory.module.filename}:{read_line}) — baked "
                     "as a compile-time constant; pass it as an operand "
                     "or key the factory's cache on it")
    return out
