"""CLI: ``python -m repro_torch.obs export`` — trace conversion and smoke.

Modes:

``export TRACE.jsonl --out perfetto.json``
    Convert a span JSONL file (``Tracer.to_jsonl``) to Chrome/Perfetto
    ``trace_event`` JSON, viewable at https://ui.perfetto.dev.

``export --smoke [--out perfetto.json] [--jsonl spans.jsonl]``
    Self-test used by CI: replays a 3-event controller trace with full
    tracing + metrics enabled, verifies the tracer is clean
    (``OBS_SPAN_UNCLOSED`` / ``OBS_SPAN_NEGATIVE``), and writes both
    export formats.  Exits non-zero on any violation.

Exit codes: 0 clean · 1 violations found · 2 usage error.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import metrics as _metrics
from .export import read_jsonl, write_chrome, write_jsonl
from .trace import Tracer, set_tracer


def _smoke_trace() -> Tracer:
    """Replay a tiny deterministic controller trace with telemetry on."""
    from ..core import (DagArrive, FleetController, RateChange, diamond_dag,
                        linear_dag, paper_library)

    tracer = Tracer(enabled=True)
    previous = set_tracer(tracer)
    _metrics.REGISTRY.enable()
    try:
        ctl = FleetController(paper_library(), budget_slots=24)
        ctl.apply(DagArrive("etl", linear_dag(), max_rate=120.0), at=0.0)
        ctl.apply(DagArrive("stats", diamond_dag(), max_rate=90.0), at=1.0)
        ctl.apply(RateChange("etl", 60.0), at=2.0)
    finally:
        set_tracer(previous)
        _metrics.REGISTRY.disable()
    return tracer


def _cmd_export(args: argparse.Namespace) -> int:
    if args.smoke:
        tracer = _smoke_trace()
        from ..analysis import verify_tracer
        violations = verify_tracer(tracer)
        spans = tracer.spans
        n_chrome = write_chrome(spans, args.out)
        if args.jsonl:
            write_jsonl(spans, args.jsonl)
        kinds = sorted({s.name for s in spans})
        print(f"smoke: {n_chrome} spans -> {args.out} "
              f"({', '.join(kinds)})")
        sample = _metrics.REGISTRY.snapshot()
        for name in sorted(sample):
            if name.startswith("repro_replan") or "events_total" in name:
                print(f"  {name}: {sample[name]}")
        if violations:
            for v in violations:
                print(f"  VIOLATION {v.code}: {v.detail}", file=sys.stderr)
            return 1
        print("  tracer verified clean")
        return 0

    if not args.input:
        print("error: INPUT.jsonl required unless --smoke", file=sys.stderr)
        return 2
    spans = read_jsonl(args.input)
    n = write_chrome(spans, args.out)
    if args.jsonl:
        write_jsonl(spans, args.jsonl)
    print(f"{n} spans -> {args.out}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Telemetry trace export and smoke checks.")
    sub = parser.add_subparsers(dest="command", required=True)

    exp = sub.add_parser("export", help="convert/emit Perfetto trace JSON")
    exp.add_argument("input", nargs="?", default=None,
                     help="span JSONL produced by Tracer.to_jsonl()")
    exp.add_argument("--out", default="obs_trace.json",
                     help="Chrome/Perfetto trace_event JSON output path")
    exp.add_argument("--jsonl", default=None,
                     help="also write span JSONL to this path")
    exp.add_argument("--smoke", action="store_true",
                     help="run the built-in 3-event traced replay and verify")
    exp.set_defaults(fn=_cmd_export)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
