"""The program's spans on the serving path (``repro_torch.obs``) and their
reading (``perfbench/program_trace.py``), on the tiny cells, on the CPU."""

import json

import numpy as np
import pytest

from perfbench import bench, program_trace, traffic

RUNNER = "serve_one_card"
#: every path from ``serve.step`` down that the serving path may open
PATHS = {
    "serve.step",
    "serve.step/serve.admit",
    "serve.step/serve.admit/serve.prefill",
    "serve.step/serve.admit/serve.prefill/model.cache_init",
    "serve.step/serve.admit/serve.prefill/model.logits",
    "serve.step/serve.admit/serve.insert",
    "serve.step/serve.admit/serve.first_token",
    "serve.step/serve.decode",
    "serve.step/serve.decode/model.logits",
    "serve.step/serve.decode/serve.sample",
}
BLOCKS = {"dense": ("block.attn_ffn",), "ssm": ("block.ssm",)}


def serve(tiny_cell, name, seed, tracer):
    """A tiny cell's engine after warm-up, serving eight drawn prompts
    with ``tracer`` as the process's; returns the system (its engine and
    the harness's prompt lengths) and each request's tokens."""
    from repro_torch import obs
    cell, cfg = tiny_cell(name)
    run = bench.load("runners", RUNNER)
    sys_ = run.build(cell, seed, "cpu", cfg)
    run.warm_up(sys_, seed)
    eng = sys_.engine
    r = traffic.rng(seed, 7)
    for n in r.integers(8, 40, 8):
        eng.submit(r.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=int(r.integers(2, 7)))
    previous = obs.set_tracer(tracer)
    try:
        done = eng.run()
    finally:
        obs.set_tracer(previous)
    return sys_, {q.rid: q.output for q in done}


@pytest.mark.parametrize("name", ["minicpm-2b.long-prompt",
                                  "mamba2-370m.long-output"])
def test_spans_nest_as_the_serving_path_opens_them(tiny_cell, name):
    from repro_torch import obs
    from repro_torch.analysis.verify import verify_tracer
    tracer = obs.Tracer(enabled=True)
    sys_, tokens = serve(tiny_cell, name, 31, tracer)
    eng = sys_.engine
    assert verify_tracer(tracer) == []
    spans = [(s.t0, s.t1, s.name) for s in tracer.spans]
    blocks = BLOCKS[tiny_cell(name)[0].config["family"]]
    allowed = PATHS | {f"{p}/{b}" for b in blocks for p in (
        "serve.step/serve.admit/serve.prefill", "serve.step/serve.decode")}
    paths = [p for _, _, p, _ in program_trace.nest(spans)]
    assert set(paths) <= allowed and "serve.step/serve.decode/serve.sample" \
        in paths
    layers = tiny_cell(name)[1].num_layers
    n_prefill = sum(p.endswith("serve.prefill") for p in paths)
    n_decode = sum(p.endswith("serve.decode") for p in paths)
    assert n_prefill == len(eng.timings["prefill"]) == 8
    assert n_decode == len(eng.timings["decode"])
    assert sum(p.rsplit("/", 1)[-1] in blocks for p in paths) == \
        layers * (n_prefill + n_decode)
    # attributes: serve.admit's prompt length is the harness's, in
    # admission order; each slot decoding emits one token a decode step
    admits = [a for _, a in program_trace.attributes(tracer.spans,
                                                     "serve.admit")]
    assert [a["prompt_len"] for a in admits] == sys_.prefill_lens
    assert all(a["queued_s"] >= 0 for a in admits)
    active = [a["active"] for _, a in program_trace.attributes(
        tracer.spans, "serve.decode")]
    assert all(1 <= n <= eng.max_batch for n in active)
    assert sum(active) == sum(len(t) - 1 for t in tokens.values())
    assert all(s.attrs == () for s in tracer.spans if s.name != "serve.admit"
               and s.name != "serve.decode")


def test_span_durations_equal_the_engines_timings(tiny_cell):
    from repro_torch import obs
    tracer = obs.Tracer(enabled=True)
    eng = serve(tiny_cell, "minicpm-2b.long-prompt", 32, tracer)[0].engine
    for name, key in (("serve.admit", "prefill"), ("serve.decode", "decode")):
        got = [s.duration for s in tracer.spans if s.name == name]
        assert len(got) == len(eng.timings[key])
        assert np.allclose(got, eng.timings[key], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["minicpm-2b.long-prompt",
                                  "mamba2-370m.long-prompt"])
def test_tracing_changes_no_token_and_records_nothing_when_off(tiny_cell,
                                                               name):
    from repro_torch import obs
    off, on = obs.Tracer(enabled=False), obs.Tracer(enabled=True)
    _, tokens_off = serve(tiny_cell, name, 33, off)
    _, tokens_on = serve(tiny_cell, name, 33, on)
    assert tokens_on == tokens_off and len(tokens_on) == 8
    assert len(off) == 0 and len(on) > 0


def test_a_traced_run_puts_every_step_inside_the_harnesss(tiny_cell):
    """A traced run with the program's spans read beside it
    (``trace_probe.traced``): its ``serve.step`` spans, on the clock
    installed after warm-up, lie inside the profiler's ``engine.step``
    spans; the runner, the profiler, the clock and the tracer are as they
    were after it; the run's own result line is unchanged."""
    from repro_torch import obs
    from perfbench import profile_span, trace_probe
    cell, cfg = tiny_cell("mamba2-370m.long-output")
    kept = (obs.get_tracer(), obs.clock.get_clock(), profile_span.warm,
            profile_span.Profiler, bench.load("runners", RUNNER).Loop)
    events = {}
    read = program_trace.read

    def keep(prof, spans, cuts):
        events.update(profiler=program_trace.profiler_events(prof),
                      spans=program_trace.intervals(spans), cuts=cuts)
        return read(prof, spans, cuts)
    mp = pytest.MonkeyPatch()
    mp.setattr(program_trace, "read", keep)
    try:
        out, got = trace_probe.traced(cell, 2**33 + 9, 2.0, device="cpu",
                                      cfg=cfg)
    finally:
        mp.undo()
    assert (obs.get_tracer(), obs.clock.get_clock(), profile_span.warm,
            profile_span.Profiler,
            bench.load("runners", RUNNER).Loop) == kept
    _, host, _ = events["profiler"]
    harness = sorted((a, b) for a, b, n in host if n == "engine.step")
    steps = [(a, b) for a, b, n in events["spans"] if n == "serve.step"]
    assert len(harness) == out.notes["traced_steps"]
    assert sum(any(ha <= a and b <= hb for ha, hb in harness)
               for a, b in steps) == len(harness)
    assert got.clock_residual_us == 0.0
    # the decode steps read are the window's outside the traced span, as
    # the runner cuts them for decode_step_ms
    assert len(got.decode) == len(out.decode_s)
    assert np.allclose([d for d, _ in got.decode], out.decode_s, atol=1e-3)
    assert 0.0 < got.decode_wait_pct() < 100.0
    assert len(got.active) == len(got.decode) and min(got.active) >= 1
    # the admissions read are the window's prefills outside the span, as
    # the harness reads them
    assert [n for n, _, _ in got.admits] == out.prefill_lens
    assert np.allclose([s for _, _, s in got.admits], out.prefill_s,
                       atol=1e-3)
    line = json.loads(json.dumps(trace_probe.summary(got, out)))
    assert line["harness"]["prompt_lens_equal"] is True
    assert line["prefill_ms_per_ktoken"] == pytest.approx(
        line["harness"]["prefill_ms_per_ktoken"], rel=0.05)
    assert got.launches["serve.decode"] and got.unmatched == 0
    assert got.window_s == pytest.approx(out.span.window_s)
    assert set(bench.result(cell, out, True)["breakdown"]) == {
        "device_ops", "idle_gaps"}


def test_a_program_without_spans_reads_nothing(tiny_cell, monkeypatch):
    """A program that opens no span (the serving path before it had
    them): the traced run is read as before, and the program's reading
    is None."""
    from repro_torch import obs
    from repro_torch.models import transformer
    from repro_torch.serve import engine
    from perfbench import trace_probe
    for mod in (engine, transformer):
        monkeypatch.setattr(mod, "_obs_span", obs.Tracer(enabled=False).span)
    cell, cfg = tiny_cell("minicpm-2b.long-prompt")
    out, got = trace_probe.traced(cell, 12, 2.0, device="cpu", cfg=cfg)
    assert got is None and out.correct
    names = set(bench.result(cell, out, True)["metrics"])
    assert {"queue_wait_p90_ms", "decode_step_ms.tails"} <= names


# -- the reductions on synthetic events ---------------------------------------

def synthetic():
    """Two engine steps on [0, 10) and [10, 20): a prefill then a decode,
    then a decode alone.  Device operations carry correlation ids whose
    launch calls fall inside or outside the program's spans."""
    spans = [
        (0.5, 9.5, "serve.step"),
        (1.0, 6.0, "serve.admit"), (1.0, 5.0, "serve.prefill"),
        (1.5, 2.0, "model.cache_init"), (2.0, 4.0, "block.ssm"),
        (5.0, 6.0, "serve.insert"),
        (6.5, 9.0, "serve.decode"), (8.0, 9.0, "serve.sample"),
        (10.2, 19.8, "serve.step"),
        (10.5, 19.5, "serve.decode"), (11.0, 18.0, "block.ssm"),
        (18.0, 19.5, "serve.sample"),
    ]
    host = [(0.0, 10.0, "engine.step"), (10.0, 20.0, "engine.step"),
            (1.0, 5.0, "model.prefill"), (9.55, 9.9, "model.decode_step")]
    # (start, end, name, correlation id); launches by id below
    dev = [(0.2, 0.8, "k", 10), (1.2, 1.6, "fill", 11), (2.5, 3.0, "k", 1),
           (3.0, 4.0, "k", 2), (4.5, 5.0, "copy", 3), (7.0, 8.5, "k", 4),
           (9.0, 9.6, "k", 9), (12.0, 13.0, "k", 5), (15.0, 16.0, "k", 6),
           (19.0, 19.2, "memcpy", 7), (30.0, 31.0, "after", 8)]
    launch = {10: 0.1, 11: 1.1, 1: 2.1, 2: 2.2, 3: 3.5, 4: 6.8, 9: 8.2,
              5: 11.5, 6: 11.6, 7: 18.5, 8: 29.0}
    return dev, host, launch, spans


def test_launches_count_operations_by_their_launch_calls():
    dev, _, launch, spans = synthetic()
    counts, unmatched = program_trace.launch_counts(
        dev + [(9.0, 9.1, "lost", 99)], launch, spans, 0.0, 20.0)
    assert counts == {"serve.prefill": [4], "serve.decode": [2, 3]}
    assert unmatched == 1
    # a span that starts outside [lo, hi] is not read
    counts, _ = program_trace.launch_counts(dev, launch, spans, 10.0, 20.0)
    assert counts == {"serve.prefill": [], "serve.decode": [3]}


def test_idle_goes_to_the_innermost_program_span():
    dev, host, _, spans = synthetic()
    idle = program_trace.idle_by_span(dev, host, spans, 0.0, 20.0)
    # each gap by its start: [0, .2) no program span; [.8, 1.2); [1.6,
    # 2.5); [4, 4.5) (block.ssm closed at 4); [5, 7); [8.5, 9) and [19.2,
    # 20); [9.6, 12) between the program's steps; [13, 15) and [16, 19)
    assert idle == pytest.approx({
        "engine.step": 0.2,
        "serve.step": 0.4,
        "serve.step/serve.admit/serve.prefill/model.cache_init": 0.9,
        "serve.step/serve.admit/serve.prefill": 0.5,
        "serve.step/serve.admit/serve.insert": 2.0,
        "serve.step/serve.decode/serve.sample": 0.5 + 0.8,
        "model.decode_step": 2.4,
        "serve.step/serve.decode/block.ssm": 2.0 + 3.0,
    })
    assert sum(idle.values()) == pytest.approx(20.0 - 7.3)


def test_clock_residual_and_window():
    _, host, launch, spans = synthetic()
    assert program_trace.clock_residual_s(host, spans) == 0.0
    late = [(a + 0.7, b + 0.7, n) for a, b, n in spans]
    assert program_trace.clock_residual_s(host, late) == pytest.approx(0.5)
    assert program_trace.window(host, spans, launch) == (0.0, 20.0)
    # no host spans (a profiler of device activity alone): the program's
    # steps that hold a launch
    assert program_trace.window([], spans, launch) == (0.5, 19.8)
    assert program_trace.window([], [], launch) is None


def records(spans):
    """The spans as the tracer records them, ``serve.decode`` with its
    ``active`` slots (3, then 5) and ``serve.admit`` with its prompt
    length and queue wait."""
    from repro_torch.obs import SpanRecord
    attrs = {"serve.decode": iter([{"active": 3}, {"active": 5}]),
             "serve.admit": iter([{"prompt_len": 2000, "queued_s": 0.25}])}
    return [SpanRecord(n, a, b, 0, 0, tuple(sorted(next(
        attrs[n], {}).items())) if n in attrs else ())
        for a, b, n in spans]


def cut(decode, prefill=(0, 0)):
    """A pair of the runner's marks over decode and prefill indices."""
    return ({"decode": decode[0], "prefill": prefill[0]},
            {"decode": decode[1], "prefill": prefill[1]})


def test_decode_wait_pairs_each_decode_with_its_sample():
    *_, spans = synthetic()
    assert program_trace.decode_steps(spans) == [
        pytest.approx((2.5, 1.0)), pytest.approx((9.0, 1.5))]
    got = program_trace.read(None, records(spans), [cut((1, 2))])
    assert got.decode == [pytest.approx((9.0, 1.5))] and got.active == [5]
    assert got.decode_wait_pct() == pytest.approx(100 * 1.5 / 9.0)
    assert got.launches == {"serve.prefill": [], "serve.decode": []}
    assert got.mean_launches("serve.decode") is None
    assert got.admits == [] and got.queue_wait_p90_ms() is None
    # both steps and the admission, and a cut past the steps recorded
    got = program_trace.read(None, records(spans),
                             [cut((0, 1), (0, 1)), cut((1, 5), (1, 3))])
    assert got.decode_wait_pct() == pytest.approx(100 * 2.5 / 11.5)
    assert got.active == [3, 5] and got.mean_active() == 4.0
    assert got.admits == [pytest.approx((2000, 0.25, 5.0))]
    assert got.queue_wait_p90_ms() == pytest.approx(250.0)
    assert got.prefill_ms_per_ktoken() == pytest.approx(2500.0)
    assert program_trace.read(None, records(spans), []).decode_wait_pct() \
        is None
    assert program_trace.read(None, records([(0.0, 1.0, "other")]), []) \
        is None


def test_the_profilers_events_are_read_or_refused():
    """The harness's profiler on the CPU gives its host spans to
    ``profiler_events``; a profiler whose raw events cannot be read is an
    error, not a reading without launches."""
    import torch
    from perfbench import profile_span
    prof = profile_span.Profiler()
    prof.start()
    with torch.profiler.record_function("engine.step"):
        torch.ones(8).add_(1)
    prof.stop()
    dev, host, _ = program_trace.profiler_events(prof)
    assert dev == [] and [n for _, _, n in host] == ["engine.step"]

    class Opaque:
        _prof = object()
    with pytest.raises(RuntimeError, match="kineto_results"):
        program_trace.profiler_events(Opaque())
    *_, spans = synthetic()
    with pytest.raises(RuntimeError):
        program_trace.read(Opaque(), records(spans), [])


def test_reading_means_and_idle_list():
    p = program_trace.ProgramReading(
        {"serve.prefill": [3000, 3010], "serve.decode": [3800, 3800, 3801]},
        {"serve.step/serve.decode": 0.5, "harness": 0.25,
         "serve.step/serve.admit/serve.prefill/block.attn_ffn": 2.0},
        1.0, [(0.1, 0.05), (0.3, 0.05)])
    assert p.mean_launches("serve.prefill") == 3005.0
    assert p.mean_launches("serve.decode") == pytest.approx(11401 / 3)
    assert p.decode_wait_pct() == pytest.approx(25.0)
    p.admits = [(1000, 0.1, 0.05), (3000, 0.3, 0.15)]
    p.active = [2, 4, 9]
    assert p.prefill_ms_per_ktoken() == pytest.approx(50.0)
    assert p.queue_wait_p90_ms() == pytest.approx(280.0)
    assert p.mean_active() == 5.0
    assert p.idle_list() == [
        ["serve.step/serve.admit/serve.prefill/block.attn_ffn", 2.0],
        ["serve.step/serve.decode", 0.5], ["harness", 0.25]]
