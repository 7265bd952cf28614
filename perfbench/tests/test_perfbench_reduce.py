"""The yardstick's arithmetic: a rate over the window, a p90 over every
request with the missing ones counted, the union of intervals for the
device's idle share, and the readers on made-up runs."""

import math

import numpy as np
import pytest

from perfbench import bench, profile_span, reduce


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 10, 143])
def test_percentile_is_numpys_linear(q, n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    assert reduce.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_counts_missing_requests():
    done = [0.1 * i for i in range(1, 10)]            # 9 requests answered
    assert reduce.percentile(done + [math.inf], 90) == math.inf
    p = reduce.percentile(done + [math.inf] + [0.05] * 10, 90)
    assert math.isfinite(p)
    assert p == pytest.approx(np.percentile(done + [1e9] + [0.05] * 10, 90))
    assert reduce.percentile([], 90) is None


def test_rate_is_all_work_over_all_time():
    assert reduce.rate(1000, 51.2) == pytest.approx(1000 / 51.2)
    with pytest.raises(ValueError):
        reduce.rate(1, 0)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    import statistics
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert reduce.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert reduce.union(ivs) == [(0.0, 2.0), (3.0, 4.0)]
    assert reduce.covered(ivs) == pytest.approx(3.0)
    assert reduce.gaps(ivs, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0),
                                           (4.0, 6.0)]
    assert reduce.covered(reduce.clip(ivs, 1.5, 3.5)) == pytest.approx(1.0)


def span_events():
    host = [(0.0, 10.0, "engine.step"), (1.0, 4.0, "model.prefill"),
            (5.0, 9.0, "model.decode_step"), (10.0, 20.0, "engine.step"),
            (11.0, 19.0, "model.decode_step")]
    dev = [(1.5, 3.0, "flash_fwd_bf16_kernel<64, true>"),
           (2.0, 3.5, "gemm"), (6.0, 8.0, "gemm"), (12.0, 13.0, "copy"),
           (-5.0, -4.0, "before the span"), (25.0, 26.0, "after it")]
    return dev, host


def test_span_reading_busy_idle_and_breakdown():
    r = profile_span.reduce_events(*span_events())
    assert r.window_s == pytest.approx(20.0)
    assert r.busy_s == pytest.approx(2.0 + 2.0 + 1.0)
    assert r.kernels == 4
    assert r.device_ops["gemm"] == pytest.approx(3.5)
    assert r.device_seconds("flash_fwd") == pytest.approx(1.5)
    # idle: [0, 1.5) engine.step 1.0 + prefill 0.5; [3.5, 6) prefill 0.5,
    # step 1.0, decode 1.0; [8, 12) decode 1.0, step 2.0, decode 1.0 ...
    idle = r.idle_by_host
    assert sum(idle.values()) == pytest.approx(20.0 - 5.0)
    assert set(idle) <= {"engine.step", "model.prefill",
                         "model.decode_step", "harness"}
    b = r.breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(3.5)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert profile_span.reduce_events([], []) is None


def outcome(**kw):
    base = dict(setup_s=12.5, window_s=50.0, tokens=2500, requests=[],
                attempted=0, failed=0, checks={"logit_gap": [0.1, 0.3]},
                memory_peak_bytes=1, device_kind="NVIDIA H100 80GB HBM3",
                device_count=1)
    base.update(kw)
    return bench.Outcome(**base)


def reading(out, name="minicpm-2b.long-prompt"):
    cell = bench.find_cell(name)
    return bench.Reading(out, cell, bench.peaks_for(out.device_kind))


def rec(due, first, done, n=10, prefill=0.1):
    return bench.RequestRecord(due, due, first, done, 1000, n, prefill)


def test_end_to_end_readers():
    reqs = [rec(i, i + 0.2 + 0.01 * i, i + 2.0, 11) for i in range(20)]
    reqs.append(rec(40.0, 45.0, 60.0, 11))            # finished after the window
    out = outcome(requests=reqs)
    rd = reading(out)
    load = bench.load
    assert load("metrics", "output_tokens_per_s").read(rd) == 50.0
    assert load("metrics", "setup_s").read(rd) == 12.5
    ttft = [r.first_token - r.due for r in reqs]
    assert load("metrics", "ttft_p90_ms").read(rd) == \
        pytest.approx(np.percentile(ttft, 90) * 1e3)
    tpot = [(r.finished - r.first_token) / 10 for r in reqs[:20]]
    assert load("metrics", "tpot_p90_ms").read(rd) == \
        pytest.approx(np.percentile(tpot, 90) * 1e3)
    waits = [t - 0.1 for t in ttft]
    assert load("metrics", "queue_wait_p90_ms").read(rd) == \
        pytest.approx(np.percentile(waits, 90) * 1e3)
    # three of twenty-one with no first token: the p90 is missing
    for r in reqs[:3]:
        r.first_token = None
    assert load("metrics", "ttft_p90_ms").read(rd) is None


def test_layer_readers():
    dev, host = span_events()
    out = outcome(span=profile_span.reduce_events(dev, host),
                  prefill_s=[0.1, 0.2], prefill_lens=[1024, 2048],
                  decode_s=[0.1, 0.12, 0.14], untraced_s=10.0,
                  span_prefill_lens=[1536])
    rd = reading(out)
    load = bench.load
    assert load("metrics", "decode_step_ms.tails").read(rd) == \
        pytest.approx(120.0)
    assert load("metrics", "prefill_share_pct").read(rd) == pytest.approx(3.0)
    assert load("metrics", "device_idle_pct.tails").read(rd) == \
        pytest.approx(75.0)
    s = rd.cell.sizes
    from perfbench.work import dense, flash
    flops = dense.prefill_flops(s, 1024) + dense.prefill_flops(s, 2048)
    assert load("metrics", "prefill_mfu_pct").read(rd) == \
        pytest.approx(100 * flops / (0.3 * 989e12))
    fl, nb = flash.work(1, 1536, 1536, 36, 36, 64, 2)
    bound = 40 * max(fl / 989e12, nb / 3.35e12)
    assert load("metrics", "flash_roofline").read(rd) == \
        pytest.approx(100 * bound / 1.5)
    # a card the table lacks: no roofline, no mfu
    out.device_kind = "cpu"
    rd = reading(out)
    assert load("metrics", "flash_roofline").read(rd) is None
    assert load("metrics", "prefill_mfu_pct").read(rd) is None
    # no traced span: the device's readers find nothing
    out.span = None
    assert load("metrics", "device_idle_pct.tails").read(rd) is None


def test_work_counts():
    from perfbench.work import flash, ssd
    assert flash.causal_pairs(4, 4) == 10
    assert flash.causal_pairs(2, 10, q_offset=5) == 6 + 7
    fl, nb = flash.work(1, 4, 4, 2, 1, 8, 2)
    assert fl == 4 * 2 * 10 * 8 and nb == (2 * 4 * 2 + 2 * 4 * 1) * 8 * 2
    fl, nb = ssd.work(1, 512, 32, 64, 128, 256, 2, False)
    pairs = 256 * 257 // 2
    per_chunk = 2 * 128 * pairs + 2 * 32 * (64 * pairs + 256 * 128 * 64)
    assert fl == 2 * per_chunk + 2 * 32 * 256 * 128 * 64


def test_queue_wait_leaves_out_the_traced_span():
    reqs = [rec(i, i + 0.2, i + 2.0, 11) for i in range(20)]
    reqs += [rec(20 + i, 30.0, 35.0, 11) for i in range(5)]  # behind the span
    out = outcome(requests=reqs, span_at=20.0)
    got = bench.load("metrics", "queue_wait_p90_ms").read(reading(out))
    assert got == pytest.approx(100.0)


def test_traced_run_reports_the_profilers_host_cost(tiny_cell):
    """A traced run notes the decode step and the prefill's seconds per
    1000 tokens inside the span beside the untraced steps'."""
    cell, cfg = tiny_cell("minicpm-2b.long-prompt")
    out = bench.load("runners", "serve_one_card").run(
        cell, seed=8, seconds=2.0, trace=True, device="cpu", cfg=cfg)
    assert out.span is not None          # no device operations on the CPU
    note = out.notes["profiler_cost"]
    assert note.startswith("decode_step_ms traced ") and " untraced " in note
    assert "prefill_ms_per_ktoken traced" in note
