"""The nemotron-3-nano-30b-a3b cell's harness on the CPU at a small size:
the comparison that decides ``correct`` passes the program, fails the
float8 control and a broken timed path (a token altered, a cache left
unchanged or never inserted, a router that leaves out its bias), as
``test_perfbench_reference.py`` holds the other families; the served
routes it follows; and the cell's two per-layer metrics and the work
counts behind them.

The reference follows the program's own choice of experts
(``runners/serve_one_card_routed.py``).  Without that, at this size (two
MoE layers, top-6 of 32 experts) a bf16 rounding that swaps a near-tied
6th and 7th expert moved a token's logits nearly as far as float8 does:
the program's widest gap 0.76-1.40 over seeds 21-28 against the
control's 1.55-3.05."""

import dataclasses
import json
import types

import pytest
import torch

from perfbench import bench, readers
from perfbench.reference.hybrid_moe import ROUTE_TOL, ROUTES
from perfbench.work import hybrid_moe as work

from conftest import make_tiny_cell
from test_perfbench_reference import alter_token, no_insert, state_unchanged

NAME = "nemotron-3-nano-30b-a3b.long-output"
#: the limit at this size (width 256, five layers), from readings on the
#: CPU over seeds 21-26 with the served routes followed: the program's
#: widest gap 0.0117-0.0370, the control's smallest 0.4197 (seeds 21-24),
#: the faults' 1.00 (the bias left out) and 4.99 (a token altered)
SMALL_LIMIT = 0.15


def no_bias(sys_):
    """The router chooses without its correction bias."""
    for b in sys_.engine.params["blocks"]:
        if "moe" in b:
            b["moe"] = {**b["moe"],
                        "bias": torch.zeros_like(b["moe"]["bias"])}


def small_cell():
    cell, cfg = make_tiny_cell(NAME)
    cfg = dataclasses.replace(cfg, d_model=256, vocab_size=512, num_heads=4,
                              num_kv_heads=2, head_dim=64, d_ff=128,
                              shared_d_ff=256, ssm_head_dim=32, ssm_heads=8,
                              num_experts=32, experts_per_token=6)
    sizes = {k: getattr(cfg, k) for k in cell.sizes}
    mix = {**cell.mix, "prompt": {"dist": "uniform", "min": 4, "max": 12},
           "output": {"dist": "uniform", "min": 12, "max": 24},
           "sample_tokens": 10 ** 6}
    own = {**cell.own, "logit_gap_limit": SMALL_LIMIT}
    return dataclasses.replace(cell, config={**cell.config, "sizes": sizes},
                               mix=mix, own=own), cfg


def run_small(fault=None, control=False, seed=21):
    """One short run of the small cell (``control``: the control's gap
    read too)."""
    cell, cfg = small_cell()
    return bench.load("runners", cell.config["runner"]).run(
        cell, seed=seed, seconds=1.5, trace=False, device="cpu", cfg=cfg,
        fault=fault, control=control)


@pytest.fixture(scope="module")
def sound():
    return run_small()


@pytest.mark.parametrize("fault", [alter_token, state_unchanged, no_insert,
                                   no_bias])
def test_a_broken_timed_path_is_not_correct(fault, sound):
    assert sound.correct, sound.checks
    broken = run_small(fault=fault)
    assert not broken.correct, broken.checks


def test_the_served_routes_are_followed(sound):
    """Every choice the program made is one the reference could make: its
    slack lies well inside the tolerance and no position is refused."""
    assert sound.notes["route_refused"] == 0
    assert 0.0 < sound.notes["route_slack"] < ROUTE_TOL / 3


@pytest.mark.parametrize("seed", (21, 22, 23))
def test_control_is_not_correct(seed):
    """The reference in float8 in the program's place fails the run's own
    comparison at a limit that the program passes, at ten times its gap."""
    out = run_small(seed=seed, control=True)
    ctrl = out.control()
    assert out.correct, out.checks
    assert not ctrl.correct, ctrl.checks
    gap, cgap = out.checks["logit_gap"][0], ctrl.checks["logit_gap"][0]
    assert cgap > 10 * gap, (gap, cgap)


def test_routes_are_kept_by_sequence():
    """The run keeps one route record a finished request, (MoE layers,
    positions, k) over its prompt and its served tokens but the last."""
    cell, cfg = small_cell()
    books = []

    def grab(sys_):
        books.append(sys_.weights)
    bench.load("runners", cell.config["runner"]).run(
        cell, seed=21, seconds=1.0, trace=False, device="cpu", cfg=cfg,
        fault=grab)
    book = books[0][ROUTES]
    assert book
    for seq, routes in book.items():
        assert routes.shape == (cfg.layer_pattern.count("E"), len(seq),
                                cfg.experts_per_token)
        assert int(routes.min()) >= 0 and int(routes.max()) < cfg.num_experts


def _reading(span_seconds=None, prefill_lens=(), decode_s=(), steps=32):
    cell = bench.find_cell(NAME)
    span = None if span_seconds is None else types.SimpleNamespace(
        device_seconds=lambda *needles: span_seconds if needles == (
            "moe_grouped",) else 0.0)
    out = types.SimpleNamespace(span=span, span_prefill_lens=list(prefill_lens),
                                decode_s=list(decode_s),
                                notes={"traced_steps": steps})
    return bench.Reading(out, cell, bench.peaks_for("NVIDIA H100 80GB HBM3"))


def test_moe_roofline_reads_the_span():
    read = bench.load("metrics", "moe_roofline").read
    assert read(_reading()) is None
    assert read(_reading(span_seconds=0.0)) is None
    rd = _reading(span_seconds=0.5, prefill_lens=[192, 300], steps=32)
    s = rd.cell.sizes

    def bound(n):
        return 23 * readers.bound_s(rd, *work.moe_work(s, n))
    want = 100.0 * (bound(192) + bound(300) + 32 * bound(64)) / 0.5
    assert read(rd) == pytest.approx(want)
    # a decode tick: the experts' bytes bound it, about 0.76 ms a layer
    assert bound(64) / 23 == pytest.approx(2.56e9 / 3.35e12, rel=1e-3)


def test_decode_mfu_reads_the_untraced_steps():
    read = bench.load("metrics", "decode_mfu_pct").read
    assert read(_reading()) is None
    rd = _reading(decode_s=[0.04, 0.06])
    flops, nbytes = work.decode_work(rd.cell.sizes, 64, 512 + 1024 + 8)
    assert read(rd) == pytest.approx(100.0 * nbytes / 3.35e12 / 0.05)
    assert nbytes / 3.35e12 > flops / 989e12


def test_work_counts_of_the_whole_model():
    conf = bench.load_json(bench.HERE / "configs"
                           / "nemotron-3-nano-30b-a3b.json")
    s = conf["sizes"]
    per = work.layer_params(s)
    total = sum(per[k] for k in s["layer_pattern"]) + s["d_model"] \
        + 2 * s["vocab_size"] * s["d_model"]
    assert total == 31_577_940_288
    flops, nbytes = work.decode_work(s, 64, 1544)
    assert 69.2e9 < nbytes < 69.4e9          # 20.7 ms at 3.35 TB/s
    fl, nb = work.moe_work(s, 64)
    assert fl == 4.0 * 384 * 2688 * 1856 and nb > 128 * 2 * 2688 * 1856 * 2
    assert work.moe_work(s, 1)[1] < work.moe_work(s, 64)[1] / 20
    assert work.prefill_flops(s, 192) > 192 * 2 * 2.8e9


def test_config_file_holds_the_catalog_numbers():
    """Every top-level number of the published config.json sits in the
    configuration's file under its own key, beside the program's sizes."""
    conf = bench.load_json(bench.HERE / "configs"
                           / "nemotron-3-nano-30b-a3b.json")
    assert conf["hidden_size"] == conf["sizes"]["d_model"] == 2688
    assert conf["n_groups"] == conf["sizes"]["ssm_groups"] == 8
    assert conf["moe_shared_expert_intermediate_size"] == 3712
    assert conf["hybrid_override_pattern"] == conf["sizes"]["layer_pattern"]
    assert conf["reduced"] == [] and json.dumps(conf)
