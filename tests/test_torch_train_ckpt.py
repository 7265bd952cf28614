"""The port's checkpointing, data pipeline and training launcher.

* ``Checkpointer``: a ``TrainState`` with a bf16 ``mu`` and an int8 ``nu``
  round-trips bit for bit (bf16 stored as its raw 16 bits), with
  ``extra``; retention keeps the newest ``keep`` steps and ``latest``
  points at the newest; an async save is complete after ``wait``; four
  steps straight equal, bit for bit, two steps, a save, a restore into a
  freshly drawn state and two more (on the CPU; on the card the
  embedding's backward adds by atomics, so a resumed run is not
  bit-equal there);
* the data pipeline against the reference's (``repro.data``):
  ``SyntheticTokens`` and ``TokenPipeline`` batches equal, and
  ``plan_pipeline``'s thread counts and slots equal;
* ``python -m repro_torch.launch.train --device cpu``: runs, checkpoints,
  resumes from its checkpoint; runs the vlm and audio families with their
  zero stand-in inputs and the scheduled pipeline; refuses the CPU unless
  asked; and ``launch.serve`` still serves with ``scale_config`` moved
  here.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import (SyntheticTokens, TokenPipeline, pipeline_dag,
                              pipeline_models, plan_pipeline)
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import Env, get_model
from repro_torch.train import (AdamWConfig, Checkpointer, init_train_state,
                               make_train_step)
from repro_torch.train.tree import tree_leaves_with_path

CPU = torch.device("cpu")


def _state(arch="mamba2-370m", seed=0, **opt):
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    return api, init_train_state(api, torch.Generator().manual_seed(seed),
                                 AdamWConfig(**opt), device="cpu")


def _assert_bit_equal(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def _batch(cfg, seed, B=2, S=16):
    return {k: torch.from_numpy(v).long() for k, v in
            SyntheticTokens(S, B, cfg.vocab_size, seed=seed).next().items()}


def test_checkpoint_roundtrip_bf16_mu_int8_nu(tmp_path):
    opt = AdamWConfig(lr=1e-2, warmup=0, mu_dtype=torch.bfloat16,
                      quantize_nu=True, quant_block=64)
    api, state = _state(**vars(opt))
    state, _ = make_train_step(api, Env(CPU, torch.float32), opt)(
        state, _batch(api.cfg, 0))                 # non-zero moments
    assert state.opt.mu["embed"].dtype == torch.bfloat16
    assert state.opt.nu["embed"].dtype == torch.int8
    ckpt = Checkpointer(str(tmp_path), keep=2, async_save=False)
    ckpt.save(3, state, extra={"note": "hello"})
    _, fresh = _state(seed=1, **vars(opt))
    restored, step, extra = ckpt.restore(fresh)
    assert step == 3 and extra == {"note": "hello"}
    assert type(restored) is type(state)
    _assert_bit_equal(restored, state)
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    dtypes = {leaf["key"]: leaf["dtype"] for leaf in manifest["leaves"]}
    assert dtypes["opt/mu/embed"] == "bfloat16"
    assert dtypes["opt/nu/embed"] == "int8"
    assert dtypes["opt/step"] == "int32"
    assert (tmp_path / "latest").read_text() == "step_00000003"


def test_checkpoint_retention_latest_and_async(tmp_path):
    _, state = _state()
    sync = Checkpointer(str(tmp_path / "sync"), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        sync.save(s, state)
    assert sync.all_steps() == [3, 4] and sync.latest_step() == 4
    lazy = Checkpointer(str(tmp_path / "async"), keep=3)
    for s in (5, 6, 7, 8):
        lazy.save(s, state, extra={"s": s})
    lazy.wait()
    assert lazy.all_steps() == [6, 7, 8] and lazy.latest_step() == 8
    restored, step, extra = lazy.restore(state)
    assert step == 8 and extra == {"s": 8}
    _assert_bit_equal(restored, state)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(state)


@pytest.mark.parametrize("arch", ["minicpm-2b", "moonshot-v1-16b-a3b"])
def test_resume_is_bit_exact_on_the_cpu(tmp_path, arch):
    opt = AdamWConfig(lr=1e-2, warmup=1, total_steps=10)
    api, state = _state(arch, **vars(opt))
    env = Env(CPU)                              # bf16 compute, remat
    step = make_train_step(api, env, opt)
    batches = [_batch(api.cfg, s) for s in range(4)]
    straight = state
    for b in batches:
        straight, m_straight = step(straight, b)
    _, half = _state(arch, **vars(opt))
    for b in batches[:2]:
        half, _ = step(half, b)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(2, half)
    _, resumed = _state(arch, seed=5, **vars(opt))
    resumed, at, _ = ckpt.restore(resumed)
    assert at == 2
    for b in batches[2:]:
        resumed, m_resumed = step(resumed, b)
    _assert_bit_equal(resumed, straight)
    assert torch.equal(m_resumed["loss"], m_straight["loss"])


# ---------------------------------------------------------------------------
# Data pipeline against the reference
# ---------------------------------------------------------------------------

def test_synthetic_tokens_match_reference():
    from repro.data import SyntheticTokens as JaxSyntheticTokens
    ours, ref = SyntheticTokens(64, 3, 5000, seed=4), \
        JaxSyntheticTokens(64, 3, 5000, seed=4)
    for _ in range(3):
        a, b = ours.next(), ref.next()
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("rate", [500.0, 4096.0, 20000.0])
def test_plan_pipeline_and_token_pipeline_match_reference(rate):
    from repro.data import (TokenPipeline as JaxTokenPipeline,
                            plan_pipeline as jax_plan_pipeline)
    ours, ref = plan_pipeline(rate), jax_plan_pipeline(rate)
    threads = {t.task: t.threads for t in ours.allocation.tasks.values()}
    assert threads == {t.task: t.threads
                       for t in ref.allocation.tasks.values()}
    assert ours.acquired_slots == ref.acquired_slots
    a = TokenPipeline(32, 2, ours, seed=1)
    b = JaxTokenPipeline(32, 2, ref, seed=1)
    assert a.workers == b.workers == threads
    for x, y in zip(a.batches(5), b.batches(5)):
        for k in ("tokens", "labels"):
            assert np.array_equal(x[k], y[k])


def test_pipeline_dag_and_live_models():
    """The DAG's shape, and Alg. 1 run live over the real operators builds
    a model for each of them that the planner takes."""
    dag = pipeline_dag()
    assert [t for t in dag.tasks] == ["src", "parse", "tokenize", "pack",
                                      "snk"]
    lib = pipeline_models(live=True, trial_seconds=0.01)
    sched = plan_pipeline(1000.0, models=lib)
    assert {t.task for t in sched.allocation.tasks.values()} >= {
        "parse", "tokenize", "pack"}


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

ARGS = ["--device", "cpu", "--scale", "10m", "--batch", "2", "--seq", "32"]


def test_train_launcher_runs_then_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    res = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", ckpt,
                                      "--ckpt-every", "2"])
    assert res["steps"] == 6 and res["start_step"] == 0
    assert all(np.isfinite(res["losses"]))
    assert res["step_ms_p50"] > 0 and res["tokens_per_s"] > 0
    assert Checkpointer(ckpt).all_steps() == [2, 4, 6]
    again = train_launcher.main(ARGS + ["--steps", "8", "--ckpt-dir", ckpt])
    assert again["start_step"] == 6 and again["steps"] == 2
    assert int(again["state"].opt.step) == 8
    assert Checkpointer(ckpt).latest_step() == 8


@pytest.mark.parametrize("arch,extra", [
    ("phi-3-vision-4.2b", []), ("whisper-large-v3", []),
    ("zamba2-1.2b", ["--real-pipeline", "--microbatches", "2"])])
def test_train_launcher_families(arch, extra):
    res = train_launcher.main(ARGS + ["--arch", arch, "--steps", "2"] + extra)
    assert res["steps"] == 2 and all(np.isfinite(res["losses"]))


def test_train_launcher_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--scale", "10m", "--steps", "1"])


def test_serve_launcher_still_serves():
    assert serve_launcher.scale_config is train_launcher.scale_config
    res = serve_launcher.main(["--device", "cpu", "--requests", "2",
                               "--prompt-len", "8", "--max-new", "3"])
    assert res["requests"] == 2 and res["tokens"] == 6


def test_scale_config_matches_reference():
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro.launch.train import scale_config as jax_scale_config
    for arch in ("minicpm-2b", "moonshot-v1-16b-a3b", "zamba2-1.2b",
                 "mamba2-370m", "whisper-large-v3", "phi-3-vision-4.2b"):
        for scale in ("10m", "100m", "full"):
            ours = train_launcher.scale_config(get_config(arch), scale)
            ref = jax_scale_config(jax_get_config(arch), scale)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
