"""The traffic generator: deterministic by seed, the same work for every
seed, an open loop's requests all due inside the window."""

import collections

import numpy as np
import pytest

from perfbench import bench, traffic

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3, -5)


def mixes():
    out = {}
    for name in ("long-prompt", "long-output"):
        mix = bench.load_json(bench.HERE / "traffic" / f"{name}.json")
        if mix["loop"] == "open":
            mix = {**mix, "rate_per_s": 3.0}
        out[name] = mix
    return out


@pytest.mark.parametrize("name", ["long-prompt", "long-output"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(name, seed):
    mix = mixes()[name]
    n = traffic.pool_size(mix, 51, 16)
    a = traffic.generate(mix, seed, 122753, n)
    b = traffic.generate(mix, seed, 122753, n)
    assert [(r.prompt_len, r.max_new, r.due) for r in a.requests] == \
        [(r.prompt_len, r.max_new, r.due) for r in b.requests]
    for j in (0, 1, n - 1, n + 5):
        assert np.array_equal(a.prompt(a.request(j)), b.prompt(b.request(j)))


@pytest.mark.parametrize("name", ["long-prompt", "long-output"])
def test_every_seed_replays_one_schedule(name):
    """Sizes, gaps and their order are the same for every seed; only the
    token ids differ."""
    mix = mixes()[name]
    n = traffic.pool_size(mix, 51, 16)
    schedules = {tuple((r.prompt_len, r.max_new, r.due)
                       for r in traffic.generate(mix, seed, 1000, n).requests)
                 for seed in SEEDS}
    assert len(schedules) == 1
    (only,) = schedules
    assert len({p for p, _, _ in only}) > 1     # shuffled, not constant


@pytest.mark.parametrize("name", ["long-prompt", "long-output"])
def test_schedule_is_shuffled_quantiles(name):
    """The schedule holds the distributions' quantiles, not sorted."""
    mix = mixes()[name]
    n = traffic.pool_size(mix, 51, 16)
    tr = traffic.generate(mix, 5, 1000, n)
    prompts = [r.prompt_len for r in tr.requests]
    assert collections.Counter(prompts) == \
        collections.Counter(traffic.lengths(mix["prompt"], n).tolist())
    assert prompts != sorted(prompts)


def test_open_loop_rate_and_window():
    mix = mixes()["long-prompt"]
    for seconds in (10, 51):
        n = traffic.pool_size(mix, seconds, 16)
        assert n == int(3.0 * seconds)
        for seed in SEEDS:
            due = [r.due for r in traffic.generate(mix, seed, 10, n).requests]
            assert due[0] == 0.0 and all(b > a for a, b in zip(due, due[1:]))
            assert due[-1] == pytest.approx((n - 1) / 3.0)
            assert due[-1] < seconds


def test_lengths_follow_the_mix():
    lp = mixes()["long-prompt"]
    p = traffic.lengths(lp["prompt"], 4096)
    assert p.min() == 512 and p.max() == 4096
    assert np.median(p) == pytest.approx(1536, abs=2)
    o = traffic.lengths(lp["output"], 2500)
    assert o.min() == 8 and o.max() == 32
    assert collections.Counter(o.tolist())[8] == 100   # uniform over 25
    lo = mixes()["long-output"]
    out = traffic.lengths(lo["output"], 4096)
    assert out.min() == 128 and out.max() == 1024
    assert np.median(out) == pytest.approx(384, abs=2)


def test_token_ids_cover_the_vocabulary_from_the_seed():
    mix = mixes()["long-prompt"]
    tr = traffic.generate(mix, 3, 50, traffic.pool_size(mix, 10, 16))
    ids = np.concatenate([tr.prompt(r) for r in tr.requests])
    assert ids.min() == 0 and ids.max() == 49 and ids.dtype == np.int32
    other = traffic.generate(mix, 4, 50, traffic.pool_size(mix, 10, 16))
    assert not np.array_equal(tr.prompt(tr.requests[0])[:8],
                              other.prompt(other.requests[0])[:8])


def test_closed_loop_cycles_its_pool():
    mix = mixes()["long-output"]
    assert traffic.clients(mix, 16) == 32
    n = traffic.pool_size(mix, 51, 16)
    assert n == 32 * mix["pool_per_client"]
    tr = traffic.generate(mix, 9, 1000, n)
    a, b = tr.request(3), tr.request(3 + n)
    assert (a.prompt_len, a.max_new) == (b.prompt_len, b.max_new)
    assert not np.array_equal(tr.prompt(a), tr.prompt(b))
