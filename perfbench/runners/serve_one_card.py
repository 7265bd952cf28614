"""Serve one configuration on one card through the port's serving engine
(``repro_torch.serve.engine.ServeEngine``), driven by the cell's traffic.

Set-up: the configuration's weights drawn from the seed on the device
(``perfbench/weights.py``), handed to the program in its layout; the
engine with the configuration's slots and a cache as long as the mix's
longest prompt and output (plus 8); one prefill at the mix's longest and
one at its shortest prompt, each with a decode step over every slot, so
that every kernel is built and the allocator holds the window's memory.
A closed loop also fills every slot before the window opens, the first
requests' budgets cut to staggered shares of their lengths so that they
finish spread over time, as in a loop that has run for a while.

The window: an open loop submits each request at its due time
(``ServeEngine.submit``) and calls ``ServeEngine.step`` while there is
work; a request that falls due during a step is submitted after it, and
its latency counts from its due time.  A closed loop sends a client's
next request as its last one finishes.  After the window an open loop
steps on, with nothing new sent, until every request due in it has
finished (two minutes at most), so that each time to first token counts
its whole wait.

A traced run (``trace``) profiles ``trace_steps`` engine steps from 60%
of the window on (``perfbench/profile_span.py``).  Every engine step and
every call of the model's ``prefill`` and ``decode_step`` runs inside a
host span of its name (``record_function``), traced or not.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import bench, check, profile_span, reduce, traffic, weights

#: where in the window the traced span starts (share of the window)
SPAN_AT = 0.6
#: seconds an open loop steps on after the window to finish its requests
DRAIN_S = 120.0


def wrap(api, lens: List[int]):
    """``api`` (a ``ModelApi``) with ``prefill`` and ``decode_step`` inside
    host spans, each prefill's prompt length appended to ``lens``."""
    def prefill(env, params, batch, max_len=None):
        lens.append(int(batch["tokens"].shape[1]))
        with record_function("model.prefill"):
            return api.prefill(env, params, batch, max_len=max_len)

    def decode_step(env, params, cache, batch):
        with record_function("model.decode_step"):
            return api.decode_step(env, params, cache, batch)
    return dataclasses.replace(api, prefill=prefill, decode_step=decode_step)


@dataclasses.dataclass
class System:
    cell: bench.Cell
    device: torch.device
    weights: Dict[str, torch.Tensor]
    engine: object
    prefill_lens: List[int]


def port_config(cell: bench.Cell):
    """The program's configuration of the cell's model, held to the sizes
    the configuration file states."""
    from repro_torch.configs import get_config
    cfg = get_config(cell.config["model"])
    wrong = {k: (v, getattr(cfg, k, None)) for k, v in cell.sizes.items()
             if getattr(cfg, k, None) != v}
    if wrong or cfg.family != cell.config["family"]:
        raise ValueError(f"{cell.config['model']}: the program's sizes differ "
                         f"from perfbench's (file, program): {wrong}")
    return cfg


def build(cell: bench.Cell, seed: int, device, cfg=None) -> System:
    """Weights, the program's params and the engine (no warm-up).
    ``cfg``: a program configuration to serve in place of the named one
    (the tests' tiny sizes, which then stand in the cell's ``sizes``)."""
    from repro_torch.models import Env, get_model
    from repro_torch.serve.engine import ServeEngine
    cfg = port_config(cell) if cfg is None else cfg
    device = torch.device(device)
    fam = cell.config["family"]
    ref = bench.load("reference", fam)
    w = weights.draw(ref.weight_spec(cell.sizes), seed, device)
    params = bench.load("layouts", fam).port_params(w, cell.sizes)
    lens: List[int] = []
    max_len = int(cell.mix["prompt"]["max"]) + int(cell.mix["output"]["max"]) + 8
    eng = ServeEngine(wrap(get_model(cfg), lens), Env(device, torch.bfloat16),
                      params, max_batch=int(cell.config["slots"]),
                      max_len=max_len)
    return System(cell, device, w, eng, lens)


def sync(sys_: System) -> None:
    if sys_.device.type == "cuda":
        torch.cuda.synchronize(sys_.device)


def warm_up(sys_: System, seed: int) -> None:
    """A prefill at the mix's longest and shortest prompts and their
    decode steps; the engine's timings cleared after."""
    eng = sys_.engine
    r = traffic.rng(seed, 3)
    for n in (int(sys_.cell.mix["prompt"]["max"]),
              int(sys_.cell.mix["prompt"]["min"])):
        eng.submit(r.integers(0, sys_.cell.sizes["vocab_size"], n)
                   .astype(np.int32), max_new_tokens=2)
    eng.run()
    sync(sys_)
    eng.timings["prefill"].clear()
    eng.timings["decode"].clear()
    sys_.prefill_lens.clear()


class Loop:
    """The window's bookkeeping: the requests sent (engine ``Request``
    objects beside their due times) and the traced span."""

    def __init__(self, sys_: System, tr: traffic.Traffic, trace: bool,
                 seconds: float):
        self.sys = sys_
        self.tr = tr
        self.sent: List = []          # (traffic.Request, due_abs, sent_abs, engine Request)
        self.trace = trace
        self.seconds = seconds
        self.prof: Optional[profile_span.Profiler] = None
        self.span_steps = int(tr.mix.get("trace_steps", 0))
        self.span_done = False
        self.span_marks: Dict[str, int] = {}
        self.span = None
        self.t_open = 0.0

    def send(self, req: traffic.Request, due_abs: float,
             max_new: Optional[int] = None) -> None:
        eng = self.sys.engine
        eng.submit(self.tr.prompt(req), max_new_tokens=max_new or req.max_new)
        self.sent.append((req, due_abs, time.perf_counter(), eng.pending[-1]))

    def emitted(self) -> int:
        return sum(len(e.output) for *_, e in self.sent)

    def step(self):
        """One engine step, inside the traced span when it is due."""
        eng = self.sys.engine
        now = time.perf_counter()
        if (self.trace and self.prof is None and not self.span_done
                and now >= self.t_open + SPAN_AT * self.seconds):
            self.prof = profile_span.Profiler()
            self.span_marks = {**self.marks(), "steps": 0}
            self.span_marks["t"] = time.perf_counter()
            self.prof.start()
        with record_function("engine.step"):
            done = eng.step()
        if self.prof is not None:
            self.span_marks["steps"] += 1
            if self.span_marks["steps"] >= self.span_steps:
                self.end_span()
        return done

    def marks(self) -> Dict[str, int]:
        """Where the engine's timings and the recorded lengths stand."""
        eng = self.sys.engine
        return {"prefill": len(eng.timings["prefill"]),
                "decode": len(eng.timings["decode"])}

    def end_span(self) -> None:
        if self.prof is None:
            return
        sync(self.sys)
        self.span_end = {**self.marks(), "t": time.perf_counter()}
        self.prof.stop()
        self.span = self.prof
        self.prof = None
        self.span_done = True

    def untraced(self, opened: Dict, closed: Dict) -> Dict:
        """The window's prefill times and lengths and decode times, and its
        seconds, less the traced span's (whose host times the profiler
        inflates)."""
        eng, lens = self.sys.engine, self.sys.prefill_lens
        cuts = [(opened, closed)]
        secs = closed["t"] - opened["t"]
        if self.span is not None:
            a, b = self.span_marks, self.span_end
            cuts = [(opened, a), (b, closed)]
            secs -= b["t"] - a["t"]
        out = {"prefill_s": [], "prefill_lens": [], "decode_s": [],
               "seconds": secs}
        for lo, hi in cuts:
            out["prefill_s"] += eng.timings["prefill"][lo["prefill"]:hi["prefill"]]
            out["prefill_lens"] += lens[lo["prefill"]:hi["prefill"]]
            out["decode_s"] += eng.timings["decode"][lo["decode"]:hi["decode"]]
        return out


    def profiler_cost(self, untraced: Dict) -> Optional[str]:
        """The engine's mean decode step and prefill seconds per 1000
        prompt tokens inside the traced span against the window's untraced
        steps: what the profiler adds to the host's time."""
        if self.span is None:
            return None
        eng, lens = self.sys.engine, self.sys.prefill_lens
        a, b = self.span_marks, self.span_end

        def per_step(xs):
            return sum(xs) / len(xs) * 1e3 if xs else None

        def per_kilotoken(xs, ns):
            return sum(xs) / sum(ns) * 1e6 if ns else None
        return (
            f"decode_step_ms traced "
            f"{per_step(eng.timings['decode'][a['decode']:b['decode']])!r} "
            f"untraced {per_step(untraced['decode_s'])!r}; "
            f"prefill_ms_per_ktoken traced "
            f"{per_kilotoken(eng.timings['prefill'][a['prefill']:b['prefill']], lens[a['prefill']:b['prefill']])!r} "
            f"untraced "
            f"{per_kilotoken(untraced['prefill_s'], untraced['prefill_lens'])!r}")


def open_loop(loop: Loop) -> float:
    """Run the window; returns its close (absolute seconds)."""
    eng = loop.sys.engine
    reqs = loop.tr.requests
    deadline = loop.t_open + loop.seconds
    i = 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        while i < len(reqs) and loop.t_open + reqs[i].due <= now:
            loop.send(reqs[i], loop.t_open + reqs[i].due)
            i += 1
        if eng.has_work():
            loop.step()
        else:
            nxt = loop.t_open + reqs[i].due if i < len(reqs) else deadline
            time.sleep(max(0.0, min(nxt, deadline) - now))
    t_close = time.perf_counter()
    for req in reqs[i:]:          # all fall due inside the window
        loop.send(req, loop.t_open + req.due)
    return t_close


def closed_loop(loop: Loop) -> float:
    """Run the window, each finished request's client sending its next
    (the pool's next request after those already sent)."""
    deadline = loop.t_open + loop.seconds
    nxt = len(loop.sent)
    while time.perf_counter() < deadline:
        for _ in loop.step():
            loop.send(loop.tr.request(nxt), time.perf_counter())
            nxt += 1
    return time.perf_counter()


def run(cell: bench.Cell, *, seed: int, seconds: float, trace: bool,
        device="cuda", started: Optional[float] = None, cfg=None,
        control: bool = False, fault=None) -> bench.Outcome:
    """One run of ``cell``.  ``cfg``: a program configuration in place of
    the cell's model (tests); ``control``: also read the
    control's gap on the same sample (``notes["control_gap"]``;
    ``perfbench/control.py``); ``fault(system)``: breaks the system after
    its warm-up (tests)."""
    started = time.perf_counter() if started is None else started
    sys_ = build(cell, seed, device, cfg)
    warm_up(sys_, seed)
    if trace:
        profile_span.warm(sys_.device)
    if fault is not None:
        fault(sys_)
    mix, slots = cell.mix, int(cell.config["slots"])
    n = traffic.pool_size(mix, seconds, slots)
    tr = traffic.generate(mix, seed, cell.sizes["vocab_size"], n)
    loop = Loop(sys_, tr, trace, seconds)
    eng = sys_.engine
    if mix["loop"] == "closed":
        clients = traffic.clients(mix, slots)
        now = time.perf_counter()
        for j in range(clients):          # every client's first request
            req = tr.request(j)
            cut = None
            if j < slots and mix.get("stagger"):
                cut = max(2, int(round(req.max_new * (j + 0.5) / slots)))
            loop.send(req, now, cut)
        loop.step()                       # fills every slot
        sync(sys_)
    if sys_.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(sys_.device)
    loop.t_open = time.perf_counter()
    opened = {**loop.marks(), "t": loop.t_open}
    setup_s = loop.t_open - started
    first_sent = len(loop.sent)
    emitted0 = loop.emitted()
    if mix["loop"] == "open":
        t_close = open_loop(loop)
    else:
        t_close = closed_loop(loop)
    sync(sys_)
    tokens = loop.emitted() - emitted0
    loop.end_span()
    closed = {**loop.marks(), "t": t_close}
    untraced = loop.untraced(opened, closed)
    profiler_cost = loop.profiler_cost(untraced)
    window_sent = loop.sent[first_sent:] if mix["loop"] == "closed" \
        else loop.sent
    if mix["loop"] == "open":             # every request due in the window
        stop = time.perf_counter() + DRAIN_S
        while any(e.finished_at is None for *_, e in window_sent) and \
                time.perf_counter() < stop:
            loop.step()
        sync(sys_)
    peak = (torch.cuda.max_memory_allocated(sys_.device)
            if sys_.device.type == "cuda" else 0)
    records = records_of(loop, window_sent, eng)
    # an open loop's requests are all due in the window: one that never
    # finished never came
    never = (sum(1 for r in records if r.finished is None)
             if mix["loop"] == "open" else 0)
    # the sample: requests finished by the end of the run
    done = [check.Served(tr.prompt(req), list(e.output))
            for req, _, _, e in loop.sent if e.finished_at is not None
            and (mix["loop"] == "open" or e.finished_at <= t_close)]
    span = loop.span
    lateness = [s - d for _, d, s, _ in window_sent] \
        if mix["loop"] == "open" else []
    # free the program's state before the reference runs
    eng.cache = None
    sys_.engine = None
    del eng
    gc.collect()
    if sys_.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = bench.load("reference", cell.config["family"])
    picked = check.sample(done, seed, int(mix["sample_tokens"]))
    gap = check.logit_gap(ref, sys_.weights, cell.sizes, picked, sys_.device)
    checks = {"logit_gap": [gap, cell.own.get("logit_gap_limit")],
              "never_answered": [never, 0]}
    out = bench.Outcome(
        setup_s=setup_s, window_s=t_close - loop.t_open, tokens=tokens,
        requests=records, attempted=len(records), failed=never,
        checks=checks, memory_peak_bytes=int(peak),
        device_kind=(torch.cuda.get_device_name(sys_.device)
                     if sys_.device.type == "cuda" else "cpu"),
        device_count=1)
    out.prefill_s = untraced["prefill_s"]
    out.prefill_lens = untraced["prefill_lens"]
    out.decode_s = untraced["decode_s"]
    out.untraced_s = untraced["seconds"]
    if span is not None:
        out.span_at = loop.span_marks["t"] - loop.t_open
        out.span = span.reading()
        out.span_prefill_lens = sys_.prefill_lens[
            loop.span_marks["prefill"]:loop.span_end["prefill"]]
        out.notes["traced_steps"] = loop.span_marks.get("steps")
        out.notes["profiler_cost"] = profiler_cost
    if lateness:
        out.notes["generator_late_s"] = (
            f"p50 {reduce.percentile(lateness, 50)!r} "
            f"p90 {reduce.percentile(lateness, 90)!r} max {max(lateness)!r}")
    if control:
        out.notes["control_gap"] = check.control_gap(
            ref, sys_.weights, cell.sizes, picked, sys_.device)
    out.notes["sampled"] = (f"{len(picked)} requests, "
                            f"{sum(len(r.output) for r in picked)} tokens")
    return out


def records_of(loop: Loop, window_sent, eng) -> List[bench.RequestRecord]:
    """Each request of the window, with the engine's prefill time matched
    in admission order."""
    t0 = loop.t_open
    admitted = sorted((e.first_token_at, idx) for idx, (*_, e)
                      in enumerate(loop.sent) if e.first_token_at is not None)
    prefill = {}
    timings = eng.timings["prefill"]
    # the engine's prefill timings since the window opened, in admission
    # order; a closed loop's set-up admissions come first
    skip = len(admitted) - len(timings)
    for k, (_, idx) in enumerate(admitted):
        if k >= skip:
            prefill[idx] = timings[k - skip]
    out = []
    base = len(loop.sent) - len(window_sent)
    for j, (req, due, sent, e) in enumerate(window_sent):
        idx = base + j
        out.append(bench.RequestRecord(
            due=due - t0, submitted=sent - t0,
            first_token=None if e.first_token_at is None
            else e.first_token_at - t0,
            finished=None if e.finished_at is None else e.finished_at - t0,
            prompt_len=req.prompt_len, n_out=len(e.output),
            prefill_s=prefill.get(idx)))
    return out
