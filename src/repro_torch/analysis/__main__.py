"""CLI for the port's static-analysis layer, a copy of the JAX package's
``python -m repro.analysis`` under the port's name.

Usage::

    python -m repro_torch.analysis src/             # lint (default: src/)
    python -m repro_torch.analysis lint src/ tests/ # same, explicit command
    python -m repro_torch.analysis flow src/        # interprocedural
    python -m repro_torch.analysis prove            # rate-stability prover
    python -m repro_torch.analysis prove --simulate # ... vs the sweep kernel
    python -m repro_torch.analysis prove --simulate --device cpu
    python -m repro_torch.analysis --list-rules     # full rule catalog
    python -m repro_torch.analysis --verify-smoke   # verifier, paper fixtures
    python -m repro_torch.analysis flow src/ --json # {"version": 2, ...}
    python -m repro_torch.analysis flow src/ --sarif out.sarif

``lint``, ``flow``, ``--list-rules``, ``--verify-smoke`` and ``prove``
without ``--simulate`` touch no device.  ``prove --simulate`` co-simulates
the planned fleet in one launch of the sweep kernel on ``--device``
(default ``cuda``; there is no silent CPU fallback); ``--device cpu`` runs
the kernel's plain PyTorch version instead.

Exit status is pinned so CI can gate on it:

* **0** — clean, or WARNING-severity findings only;
* **1** — at least one ERROR-severity finding (lint/flow rule hit,
  verifier error, prover disagreement under ``prove --simulate``);
* **2** — usage error or source that failed to parse (``LINT000``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from ..core.diagnostics import Severity, Violation
from .lint import RULES, lint_paths

JSON_VERSION = 2       # bumped when the --json finding shape changes

_SUBCOMMANDS = ("lint", "flow", "prove")


def _print(violations: List[Violation], as_json: bool) -> None:
    if as_json:
        print(json.dumps({
            "version": JSON_VERSION,
            "findings": [{
                "code": v.code, "severity": v.severity.value,
                "artifact": v.artifact, "path": v.path, "detail": v.detail,
            } for v in violations]}, indent=2))
    else:
        for v in violations:
            print(v)


def _exit_code(violations: List[Violation]) -> int:
    """Pinned mapping: parse failure > rule errors > warnings-only."""
    if any(v.code == "LINT000" for v in violations):
        return 2
    if any(v.severity is Severity.ERROR for v in violations):
        return 1
    return 0


def _finish(violations: List[Violation], label: str, as_json: bool,
            sarif: Optional[str]) -> int:
    _print(violations, as_json)
    if sarif:
        from .sarif import write_sarif
        write_sarif(sarif, violations)
        print(f"{label}: wrote {sarif}", file=sys.stderr)
    code = _exit_code(violations)
    if code:
        print(f"{label}: {len(violations)} finding(s)", file=sys.stderr)
    elif violations:
        print(f"{label}: clean ({len(violations)} warning(s))")
    else:
        print(f"{label}: clean")
    return code


def list_rules() -> int:
    from .flow import FLOW_RULES
    from .prove import RATE_RULES
    for rule in RULES:
        head = (rule.doc or "").strip().splitlines()
        print(f"{rule.code}  {rule.name}: {head[0] if head else ''}")
    print("LINT001  unknown-suppression-code: a `lint: ok` comment names "
          "a code no rule emits")
    for code, name, summary in FLOW_RULES + RATE_RULES:
        print(f"{code}  {name}: {summary}")
    return 0


def verify_smoke() -> List[Violation]:
    """Build the paper fixtures fresh and run every verifier pass on them.

    Covers all seven passes: the micro/app DAG zoo, the paper model
    tables, a deep single-DAG plan, a deep 3-DAG ``plan_fleet``, and a
    short event trace driven through a validating ``FleetController``."""
    from ..core import (ALL_DAGS, DagArrive, DagDepart, FleetController,
                        RateChange, paper_library, plan, plan_fleet)
    from ..core.online import EventTrace
    from . import verify as V

    lib = paper_library()
    out: List[Violation] = []
    out.extend(V.verify_models(lib))
    dags = {}
    for name, maker in ALL_DAGS.items():
        dag = maker()
        dags[name] = dag
        out.extend(V.verify_dag(dag))

    sched = plan(dags["linear"], 40.0, lib, validate=False)
    out.extend(V.verify_dag(sched.dag))
    out.extend(V.verify_allocation(sched.allocation, sched.dag, lib))
    out.extend(V.verify_schedule(sched))

    fleet_dags = {k: dags[k] for k in ("linear", "diamond", "star")}
    fp = plan_fleet(fleet_dags, lib, budget_slots=30, validate=False)
    out.extend(V.verify_fleet_plan(fp, lib, deep=True))

    trace = EventTrace([
        (0.0, DagArrive("linear", dags["linear"], weight=1.0)),
        (1.0, DagArrive("diamond", dags["diamond"], weight=1.0)),
        (2.0, RateChange("linear", max_rate=80.0)),
        (3.0, DagDepart("diamond")),
    ])
    out.extend(V.verify_trace(trace))
    ctl = FleetController(lib, budget_slots=24, validate=False)
    for t, ev in trace:
        ctl.apply(ev, at=t)
    out.extend(V.verify_controller(ctl, deep=True))
    return out


def run_prove(args: argparse.Namespace) -> int:
    """Plan a paper-fixture fleet, prove the whole rate sweep, and (with
    ``--simulate``) cross-check every decided cell against the
    co-simulation's stable/unstable verdict: one sweep-kernel launch on
    ``--device`` (its plain PyTorch version on ``cpu``)."""
    import numpy as np
    from ..core import (DagArrive, FleetController, diamond_dag,
                        linear_dag, paper_library, star_dag)
    from .prove import PROVED_STABLE, PROVED_UNSTABLE, prove_fleet

    lib = paper_library()
    ctl = FleetController(lib, budget_slots=args.budget_slots, mapper="sam",
                          step=10.0, max_rate=args.max_rate, validate=False)
    for name, dag in (("linear", linear_dag()), ("diamond", diamond_dag()),
                      ("star", star_dag())):
        ctl.apply(DagArrive(name, dag))

    fracs = np.linspace(0.25, 1.25, 9)
    proofs = prove_fleet(ctl.plan, ctl.models, fractions=fracs)
    violations: List[Violation] = []
    decided = total = 0
    for name, prs in sorted(proofs.items()):
        cells = []
        for p in prs:
            total += 1
            decided += p.proved
            mark = {PROVED_STABLE: "S", PROVED_UNSTABLE: "U"}.get(
                p.verdict, "?")
            cells.append(f"{p.omega:g}:{mark}")
            violations.extend(p.violations)
        print(f"prove: {name}  " + "  ".join(cells))
    print(f"prove: {decided}/{total} cells decided "
          "(S proved stable, U proved unstable, ? unprovable)")

    if args.simulate:
        report = ctl.cosimulate(fractions=fracs, duration=8.0, dt=0.1,
                                engine="scan", device=args.device)
        mismatches = 0
        for name, prs in proofs.items():
            entry = report.entries.get(name)
            if entry is None:
                continue
            for k, p in enumerate(prs):
                if not p.proved:
                    continue
                sim_stable = entry.results[k].stable
                want = p.verdict == PROVED_STABLE
                if sim_stable != want:
                    mismatches += 1
                    violations.append(Violation(
                        "RATE309", Severity.ERROR, name,
                        f"{name}@{p.omega:g}",
                        f"prover says {p.verdict} but the co-simulation "
                        f"says {'stable' if sim_stable else 'unstable'}"))
        print(f"prove: simulate cross-check — {mismatches} mismatch(es) "
              f"over {total} cells")

    if args.json:
        print(json.dumps({
            "version": JSON_VERSION,
            "cells": {name: [{
                "omega": p.omega, "verdict": p.verdict,
                "margin": p.margin, "binding": p.binding,
            } for p in prs] for name, prs in sorted(proofs.items())},
            "findings": [{
                "code": v.code, "severity": v.severity.value,
                "artifact": v.artifact, "path": v.path, "detail": v.detail,
            } for v in violations]}, indent=2))
    if args.sarif:
        from .sarif import write_sarif
        write_sarif(args.sarif, violations)
        print(f"prove: wrote {args.sarif}", file=sys.stderr)

    # RATE301/304 on genuinely-unstable cells are expected output here, not
    # failures: the command's contract is "decide and report".  Only a
    # cross-check mismatch (RATE309) fails the run.
    return 1 if any(v.code == "RATE309" for v in violations) else 0


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="JAX-hazard/race lint, interprocedural flow analyses, "
                    "plan-integrity verifier, and rate-stability prover")
    ap.add_argument("command", nargs="?", default="lint",
                    choices=_SUBCOMMANDS, help="analysis to run")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/directories to analyze (default: src/)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as versioned JSON")
    ap.add_argument("--sarif", metavar="PATH",
                    help="also write findings as SARIF 2.1.0 to PATH")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the full rule catalog and exit")
    ap.add_argument("--include-suppressed", action="store_true",
                    help="report findings even when suppressed")
    ap.add_argument("--verify-smoke", action="store_true",
                    help="build paper fixtures and run all verifier passes")
    ap.add_argument("--simulate", action="store_true",
                    help="prove: cross-check decided cells against the "
                         "co-simulation")
    ap.add_argument("--budget-slots", type=int, default=12,
                    help="prove: fleet slot budget (default 12)")
    ap.add_argument("--max-rate", type=float, default=300.0,
                    help="prove: offered-load ceiling t/s (default 300)")
    ap.add_argument("--device", default="cuda",
                    help="prove --simulate: where the sweep runs (default "
                         "cuda, the sweep kernel; cpu: its plain version)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    # back-compat: `python -m repro_torch.analysis src/` (path first, no
    # subcommand) still means lint
    if raw and not raw[0].startswith("-") and raw[0] not in _SUBCOMMANDS:
        raw.insert(0, "lint")
    args = _build_parser().parse_args(raw)

    if args.list_rules:
        return list_rules()

    if args.verify_smoke:
        violations = verify_smoke()
        _print(violations, args.json)
        if args.sarif:
            from .sarif import write_sarif
            write_sarif(args.sarif, violations)
        errors = [v for v in violations if v.severity is Severity.ERROR]
        if errors:
            print(f"verify-smoke: {len(errors)} error(s)", file=sys.stderr)
            return 1
        print(f"verify-smoke: clean ({len(violations)} warning(s))"
              if violations else "verify-smoke: clean")
        return 0

    if args.command == "prove":
        if args.paths:
            print("prove: takes no paths (it proves the paper-fixture "
                  "fleet); see --budget-slots/--max-rate", file=sys.stderr)
            return 2
        return run_prove(args)

    paths = args.paths or ["src/"]
    if args.command == "flow":
        from .flow import analyze_paths
        findings = analyze_paths(
            paths, include_suppressed=args.include_suppressed)
        return _finish(findings, "flow", args.json, args.sarif)

    findings = lint_paths(paths, include_suppressed=args.include_suppressed)
    return _finish(findings, "lint", args.json, args.sarif)


if __name__ == "__main__":
    sys.exit(main())
