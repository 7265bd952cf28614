"""One run of one cell: the harness around a runner.

``BENCHMARK.json`` names the cell; everything that belongs to it is found
by name in files of its own:

* ``configs/<config>.json``: the model's name in ``repro_torch.configs``,
  its sizes as run, its source, slots, chips, ``family`` and ``runner``;
* ``traffic/<traffic>.json``: the mix (``perfbench/traffic.py``);
* ``cells/<cell>.json`` (optional): the cell's own numbers, set over the
  mix's keys (the offered rate) and the correctness limit;
* ``runners/<runner>.py``: builds the system, runs the window and the
  check, returns an :class:`Outcome`;
* ``reference/<family>.py``, ``layouts/<family>.py``, ``work/*.py``;
* ``metrics/<metric>.py``: one reader a metric, ``read(reading)`` ->
  a number or None (nothing to read: the metric is left out).

The result is the last line of standard output; the numbers compared for
``correct`` are the last lines of standard error and the result's last
key (``checks``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import pathlib
import sys
import time
from typing import Any, Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(kind: str, name: str):
    """The module ``perfbench/<kind>/<name>.py``: imported as
    ``perfbench.<kind>.<name>`` where the name is an identifier, else
    loaded from its path (a metric's name may hold dots)."""
    import importlib
    if name.isidentifier():
        return importlib.import_module(f"perfbench.{kind}.{name}")
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no perfbench/{kind}/{name}.py")
    modname = f"perfbench.{kind}._" + "".join(
        c if c.isalnum() else "_" for c in name)
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
    return sys.modules[modname]


def applies(entry: Dict, cell: str, reported: List[str]) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is read in ``cell``: listed
    under its ``workloads``, or, without that key, for an end-to-end
    metric always and for a per-layer one where the cell reports the
    end-to-end metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in reported


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict            # configs/<config>.json
    mix: Dict               # traffic/<traffic>.json with cells/<cell>.json over it
    own: Dict               # cells/<cell>.json
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def sizes(self) -> Dict:
        return self.config["sizes"]


def find_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    config = load_json(HERE / "configs" / f"{w['config']}.json")
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    own_path = HERE / "cells" / f"{name}.json"
    own = load_json(own_path) if own_path.is_file() else {}
    mix = {**mix, **{k: v for k, v in own.items() if k in mix}}
    e2e = [m for m in bench["end_to_end"] if applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, mix, own, e2e, per)


@dataclasses.dataclass
class RequestRecord:
    """One request of the window, its times in seconds after the window
    opened: when it fell due (an open loop's schedule; a closed loop's
    send), was submitted, got its first token and finished (None: not
    by the end of the run)."""
    due: float
    submitted: float
    first_token: Optional[float]
    finished: Optional[float]
    prompt_len: int
    n_out: int
    prefill_s: Optional[float] = None


@dataclasses.dataclass
class Outcome:
    """What a runner hands back: everything the readers read."""
    setup_s: float
    window_s: float                 # the measured window, open to close
    tokens: int                     # output tokens emitted inside it
    requests: List[RequestRecord]   # the requests due inside it
    attempted: int
    failed: int
    checks: Dict[str, List]         # name -> [value, limit]; pass: value <= limit
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    span: Any = None                # profile_span.SpanReading of the traced run
    # the engine's timings of the window's steps outside the traced span,
    # each prefill's prompt length, and those steps' seconds
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    prefill_lens: List[int] = dataclasses.field(default_factory=list)
    decode_s: List[float] = dataclasses.field(default_factory=list)
    untraced_s: float = 0.0
    span_prefill_lens: List[int] = dataclasses.field(default_factory=list)
    span_at: Optional[float] = None  # when the traced span began (window seconds)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v is not None and lim is not None and v <= lim
            for v, lim in self.checks.values())

    def control(self) -> "Outcome":
        """This outcome with the control's gap (``notes["control_gap"]``,
        the float8 reference in the program's place) judged in place of
        the program's, against the same limits."""
        lim = self.checks["logit_gap"][1]
        return dataclasses.replace(self, checks={
            **self.checks, "logit_gap": [self.notes["control_gap"], lim]})


@dataclasses.dataclass
class Reading:
    """A reader's view of a run: the outcome, the cell, and the chip's
    peaks (None for a card the table lacks)."""
    outcome: Outcome
    cell: Cell
    peaks: Optional[Dict[str, float]]


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    return load_json(HERE / "peaks.json").get(kind)


def read_metrics(entries: List[Dict], reading: Reading, required: bool
                 ) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        value = load("metrics", m["name"]).read(reading)
        if value is None:
            if required:
                raise RuntimeError(f"end-to-end metric {m['name']} has no "
                                   "reading")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result(cell: Cell, out: Outcome, trace: bool) -> Dict:
    peaks = peaks_for(out.device_kind)
    reading = Reading(out, cell, peaks)
    entries = cell.per_layer if trace else cell.end_to_end
    res: Dict[str, Any] = {
        "correct": out.correct, "attempted": out.attempted,
        "failed": out.failed,
        "metrics": read_metrics(entries, reading, required=not trace),
        "device": {"platform": "gpu", "kind": out.device_kind,
                   "count": out.device_count,
                   "memory_peak_bytes": out.memory_peak_bytes}}
    if trace and out.span is not None:
        res["device"].update(busy_s=out.span.busy_s,
                             window_s=out.span.window_s)
        res["breakdown"] = out.span.breakdown()
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in out.checks.items()}
    return res


def cache_dirs() -> None:
    """Every cache a run may fill, at fixed paths inside the checkout."""
    base = ROOT / "build" / "perfbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv: Optional[List[str]] = None, started: Optional[float] = None
         ) -> int:
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = load("runners", cell.config["runner"])
    out = run.run(cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device="cuda", started=started)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    res = result(cell, out, bool(args.trace))
    for k, v in out.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
