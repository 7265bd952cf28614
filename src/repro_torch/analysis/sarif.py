"""SARIF 2.1.0 serialization of
:class:`~repro_torch.core.diagnostics.Violation`.

One run, one tool (``repro_torch.analysis``), one result per finding.  The
rule table merges the lint catalog (:data:`repro_torch.analysis.lint.RULES`),
the interprocedural catalog (:data:`repro_torch.analysis.flow.FLOW_RULES`)
and the prover catalog (:data:`repro_torch.analysis.prove.RATE_RULES`) — the
prover table is inlined here rather than imported so writing a SARIF file
never pulls in numpy.

``Violation.path`` is ``"<file>:<line>"`` for source findings; anything
that does not parse that way (verifier artifacts like
``"fleet/linear/alloc"``) becomes a logical location instead of a
physical one, which GitHub code scanning accepts.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..core.diagnostics import Severity, Violation

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

_LEVEL = {Severity.ERROR: "error", Severity.WARNING: "warning"}


def _rule_table() -> Dict[str, Tuple[str, str]]:
    """code -> (name, summary) for every rule the analyzers can emit."""
    from .flow import FLOW_RULES
    from .lint import RULES
    table: Dict[str, Tuple[str, str]] = {}
    for rule in RULES:
        head = (rule.doc or "").strip().splitlines()
        table[rule.code] = (rule.name, head[0] if head else rule.name)
    table["LINT001"] = ("unknown-suppression-code",
                        "a `lint: ok` comment names a code no rule emits")
    for code, name, summary in FLOW_RULES:
        table[code] = (name, summary)
    # RATE_RULES duplicated from prove.py so this module stays numpy-free
    for code, name, summary in (
            ("RATE301", "proved-unstable",
             "demand lower bound exceeds capacity — proved unstable"),
            ("RATE302", "borderline-cell",
             "demand interval straddles capacity — unprovable"),
            ("RATE303", "cpu-oversub-unprovable",
             "slot CPU upper bound exceeds its core — unprovable"),
            ("RATE304", "zero-capacity-demand",
             "positive demand on a zero-capacity group — proved unstable"),
            ("RATE305", "allocation-rate-mismatch",
             "allocated rate outside the §6 recurrence interval"),
            ("RATE309", "prover-simulator-disagreement",
             "prover-decided cell disagrees with the co-simulation")):
        table[code] = (name, summary)
    return table


def _split_path(path: str) -> Tuple[Optional[str], Optional[int]]:
    """``"src/x.py:42"`` -> (``"src/x.py"``, 42); else (None, None)."""
    if ":" in path:
        head, _, tail = path.rpartition(":")
        if head and tail.isdigit():
            return head, int(tail)
    return None, None


def to_sarif(violations: List[Violation]) -> Dict:
    """Render findings as one SARIF 2.1.0 log object (a plain dict)."""
    table = _rule_table()
    seen_codes: List[str] = []
    results = []
    for v in violations:
        if v.code not in seen_codes:
            seen_codes.append(v.code)
        result: Dict = {
            "ruleId": v.code,
            "ruleIndex": 0,          # fixed up after the rule array exists
            "level": _LEVEL.get(v.severity, "warning"),
            "message": {"text": v.detail},
        }
        uri, line = _split_path(v.path)
        if uri is not None:
            result["locations"] = [{
                "physicalLocation": {
                    "artifactLocation": {"uri": uri.replace("\\", "/")},
                    "region": {"startLine": max(1, line or 1)},
                }}]
        else:
            result["locations"] = [{
                "logicalLocations": [{"fullyQualifiedName": v.path}]}]
        results.append(result)

    rules = []
    index = {}
    for code in sorted(seen_codes):
        name, summary = table.get(code, (code.lower(), code))
        index[code] = len(rules)
        rules.append({
            "id": code,
            "name": name,
            "shortDescription": {"text": summary},
        })
    for r in results:
        r["ruleIndex"] = index[r["ruleId"]]

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "repro_torch.analysis",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def write_sarif(path: str, violations: List[Violation]) -> None:
    """Serialize ``violations`` to ``path`` as a SARIF 2.1.0 JSON file."""
    with open(path, "w") as f:
        json.dump(to_sarif(violations), f, indent=2)
        f.write("\n")
