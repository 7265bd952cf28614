"""The program's own spans read beside a cell's traced run, on the card, in
one process a command:

    python3 perfbench/trace_probe.py --workload mamba2-370m.long-output --seed 7
    python3 perfbench/trace_probe.py --workload mamba2-370m.long-output \\
        --seed 7 --cuda-only
    python3 perfbench/trace_probe.py --workload minicpm-2b.long-output \\
        --seed 7 --seconds 20 --obs-cost off,on,on,off

A traced run of the cell through its runner, as ``run.py --trace 1``
makes it, with the program's spans recorded on the profiler's clock from
the end of warm-up to the window's close (``program_trace.install``, at
the runner's call of ``profile_span.warm``) and read with the traced
span's profiler events (``program_trace.read``, at the runner's cut of
its untraced steps).  Prints one JSON line: the run's result line as
``run.py`` prints it, and under ``program`` the launches per
``serve.prefill`` and ``serve.decode`` of the traced span, the host's
wait per decode (``serve.sample`` over ``serve.decode``) and the slots
decoding (``active``) over the window's steps outside it, the idle
seconds by program span, the clock check, and over the window's prefills
outside it the queue wait and prefill ms per 1000 tokens from
``serve.admit``'s ``queued_s``, ``prompt_len`` and seconds, beside the
harness's prompt lengths and prefill times.

``traced`` patches ``profile_span.warm`` and the runner's ``Loop`` for the
one run; it stands in until the runner installs and reads the program's
spans itself (``program_trace.install`` / ``read``), and goes then, with
``--cuda-only``'s ``DeviceOnly``; ``program_trace`` stays the one reader.

``--cuda-only``: the profiler on the device's activity alone
(``ProfilerActivity.CUDA``), so that it records no host operation and no
harness span and costs the host less; the traced span is then the
program's ``serve.step`` spans during which the profiler saw a launch
call.

``--obs-cost``: untraced runs in turn with the program's tracing off or
on (installed over the whole run): each run's mean decode step and
prefill ms per 1000 prompt tokens, then the host's cost of one span
call, disabled and enabled, and the span calls a decode step makes.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import bench, profile_span, program_trace  # noqa: E402


class DeviceOnly(profile_span.Profiler):
    """The harness's profiler on the device's activity alone."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])


def traced(cell, seed, seconds, cuda_only=False, **run_kw):
    """One traced run of ``cell`` with the program's spans read beside
    it; returns the outcome and the ``ProgramReading`` (None for a
    program that opens no span).  ``run_kw``: more of the runner's
    arguments (the tests' device and configuration)."""
    runner = bench.load("runners", cell.config["runner"])
    got = {}
    warm = profile_span.warm

    def warm_then_install(device):
        warm(device)
        got["installed"] = program_trace.install()

    class Read(runner.Loop):
        def untraced(self, opened, closed):
            cuts = ([(opened, self.span_marks), (self.span_end, closed)]
                    if self.span is not None else [(opened, closed)])
            got["reading"] = program_trace.read(
                self.span, program_trace.restore(got.pop("installed")), cuts)
            return super().untraced(opened, closed)

    patches = [(profile_span, "warm", warm_then_install),
               (runner, "Loop", Read)]
    if cuda_only:
        patches.append((profile_span, "Profiler", DeviceOnly))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        out = runner.run(cell, seed=seed, seconds=seconds, trace=True,
                         **run_kw)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        if "installed" in got:
            program_trace.restore(got.pop("installed"))
    return out, got.get("reading")


def summary(p: program_trace.ProgramReading, out: bench.Outcome) -> dict:
    """The program's reading, and beside its admissions the harness's
    reading of the same prefills (``wrap``'s ``lens``, ``timings``)."""
    lens = [n for n, _, _ in p.admits]
    return {
        "prefill_launches": p.mean_launches("serve.prefill"),
        "decode_launches": p.mean_launches("serve.decode"),
        "launches": {n: [len(c), min(c, default=None), max(c, default=None)]
                     for n, c in p.launches.items()},
        "unmatched": p.unmatched,
        "decode_wait_pct": p.decode_wait_pct(),
        "decode_steps_read": len(p.decode),
        "clock_residual_us": p.clock_residual_us,
        "window_s": p.window_s, "busy_s": p.busy_s,
        "idle_pct": (100.0 * (1 - p.busy_s / p.window_s)
                     if p.window_s > 0 else None),
        "idle_by_program_span": p.idle_list(),
        "mean_active": p.mean_active(),
        "admissions_read": len(p.admits),
        "queue_wait_p90_ms": p.queue_wait_p90_ms(),
        "prefill_ms_per_ktoken": p.prefill_ms_per_ktoken(),
        "harness": {
            "prompt_lens_equal": lens == list(out.prefill_lens),
            "prefill_ms_per_ktoken": (sum(out.prefill_s)
                                      / sum(out.prefill_lens) * 1e6
                                      if out.prefill_lens else None)}}


def per_call_us(enabled: bool, n: int = 200000) -> float:
    """Host microseconds of one ``with span(...)`` on the process tracer,
    with the traced run's clock installed."""
    from repro_torch import obs
    from repro_torch.obs.trace import span
    installed = program_trace.install()
    obs.get_tracer().enabled = enabled
    try:
        t = time.perf_counter()
        for _ in range(n):
            with span("probe"):
                pass
        return (time.perf_counter() - t) / n * 1e6
    finally:
        program_trace.restore(installed)


def calls_per_decode(spans) -> float:
    """The span calls of a decode step: ``serve.step``, ``serve.decode``
    and every span inside a ``serve.decode``."""
    paths = [p for _, _, p, _ in program_trace.nest(spans)]
    decodes = sum(p.endswith("serve.decode") for p in paths)
    inside = sum("serve.decode/" in p for p in paths)
    return 2 + inside / decodes if decodes else 0.0


def obs_cost(cell, seed, seconds, order, **run_kw):
    """Untraced runs, the program's tracing off or on in ``order``; one
    JSON line each, and last the cost of one span call."""
    runner = bench.load("runners", cell.config["runner"])
    for mode in order:
        installed = program_trace.install() if mode == "on" else None
        try:
            out = runner.run(cell, seed=seed, seconds=seconds, trace=False,
                             **run_kw)
        finally:
            spans = (program_trace.intervals(program_trace.restore(installed))
                     if installed else [])
        print(json.dumps({
            "workload": cell.name, "seed": seed, "mode": f"obs-{mode}",
            "correct": out.correct, "device": out.device_kind,
            "decode_steps": len(out.decode_s),
            "decode_step_ms": sum(out.decode_s) / len(out.decode_s) * 1e3,
            "prefill_ms_per_ktoken": (sum(out.prefill_s)
                                      / sum(out.prefill_lens) * 1e6),
            "calls_per_decode": calls_per_decode(spans) if spans else None,
            "output_tokens_per_s": out.tokens / out.window_s}), flush=True)
    return {"workload": cell.name, "mode": "span-call",
            "disabled_us": per_call_us(False),
            "enabled_us": per_call_us(True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--cuda-only", action="store_true")
    mode.add_argument("--obs-cost", help="off/on, in turn: off,on,on,off")
    args = ap.parse_args(argv)
    bench.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("trace_probe: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    if args.obs_cost:
        got = obs_cost(cell, args.seed, args.seconds,
                       args.obs_cost.split(","))
    else:
        out, p = traced(cell, args.seed, args.seconds, args.cuda_only)
        got = {"workload": cell.name, "seed": args.seed,
               "mode": "cuda-only" if args.cuda_only else "traced",
               "result": bench.result(cell, out, True), "notes": out.notes,
               "program": summary(p, out) if p is not None else None}
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
