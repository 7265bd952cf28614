"""Trace export: JSONL and Chrome/Perfetto ``trace_event`` JSON files."""

from __future__ import annotations

import json
from typing import Iterable, Optional

from .trace import SpanRecord, Tracer, spans_from_jsonl, spans_to_chrome

__all__ = [
    "write_jsonl", "write_chrome", "read_jsonl", "export_tracer",
]


def write_jsonl(spans: Iterable[SpanRecord], path: str) -> int:
    """Write one span per line; returns the number of spans written."""
    spans = list(spans)
    with open(path, "w") as f:
        for span in spans:
            f.write(json.dumps(span.to_json(), sort_keys=True) + "\n")
    return len(spans)


def write_chrome(spans: Iterable[SpanRecord], path: str) -> int:
    """Write Chrome/Perfetto ``trace_event`` JSON (open at ui.perfetto.dev)."""
    spans = list(spans)
    with open(path, "w") as f:
        json.dump(spans_to_chrome(spans), f, indent=1, sort_keys=True)
        f.write("\n")
    return len(spans)


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return spans_from_jsonl(f.read())


def export_tracer(tracer: Tracer, *, jsonl: Optional[str] = None,
                  chrome: Optional[str] = None) -> int:
    """Export a tracer's spans to the requested file formats."""
    spans = tracer.spans
    if jsonl:
        write_jsonl(spans, jsonl)
    if chrome:
        write_chrome(spans, chrome)
    return len(spans)
