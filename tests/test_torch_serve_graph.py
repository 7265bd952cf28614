"""The serving engine's decode step replayed as a CUDA graph, against the
same step run eagerly, on the card (``cuda`` marker; they skip elsewhere).

One tiny configuration of each family (hybrid_moe's: every kind of
layer, its dropless MoE's sort and grouped kernels inside the graph) serves five ragged requests on two
slots, so freed slots are refilled by later requests.  Before each tick
the eager ``decode_step`` runs on a clone of the engine's cache and the
same inputs: the replay must choose the same greedy tokens, write the same
cache, and its logits lie within bf16's tolerance of the eager call's.
A second test replays the graph by hand with changing inputs, on the
current device and on another one, against the eager step.
The file imports no JAX, so it runs where only PyTorch is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import scale_config
from repro_torch.models import Env, get_model
from repro_torch.serve import ServeEngine

FAMILIES = ("minicpm-2b", "moonshot-v1-16b-a3b", "phi-3-vision-4.2b",
            "mamba2-370m", "zamba2-1.2b", "whisper-large-v3",
            "nemotron-3-nano-30b-a3b")
BUDGETS = [3, 6, 2, 5, 4]
#: bf16 logits, relative to 1 + the largest (``chip_smoke.TOLS``)
TOL = 2e-2


def _tiny(arch):
    cfg = scale_config(get_config(arch), "10m")
    if cfg.family == "hybrid":      # the shared block runs at 4 layers
        cfg = dataclasses.replace(cfg, attn_period=cfg.num_layers // 2)
    return cfg


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class _Shadowed(ServeEngine):
    """An engine that runs the eager step on a clone of its cache before
    each tick and holds the tick to it."""

    def __init__(self, api, *args, **kwargs):
        self.eager_api = api
        self.outputs = []           # the decode step's logits, as returned
        recording = dataclasses.replace(api, decode_step=self._record)
        super().__init__(recording, *args, **kwargs)
        self.ticks = 0
        self.logit_err = []

    def _record(self, env, params, cache, batch):
        logits, cache = self.eager_api.decode_step(env, params, cache, batch)
        self.outputs.append(logits)
        return logits, cache

    def _decode_tick(self):
        if not any(r is not None for r in self.slot_req):
            return []
        dev = self.env.device
        clone = {k: t.clone() for k, t in self.cache.items()}
        logits, clone = self.eager_api.decode_step(
            self.env, self.params, clone,
            {"tokens": torch.as_tensor(self.slot_last_token[:, None],
                                       dtype=torch.long, device=dev),
             "pos": torch.as_tensor(self.slot_pos, dtype=torch.long,
                                    device=dev)})
        want = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32).cpu()
        done = super()._decode_tick()
        self.ticks += 1
        replayed = self.outputs[-1]        # the graph's static output
        scale = 1.0 + float(logits.float().abs().max())
        self.logit_err.append(
            float((replayed.float() - logits.float()).abs().max()) / scale)
        assert torch.equal(self._next.cpu(), want), self.ticks
        for name, t in self.cache.items():
            torch.testing.assert_close(t, clone[name], rtol=0, atol=0,
                                       msg=f"{name} after tick {self.ticks}")
        return done


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_graphed_decode_matches_eager(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _tiny(arch)
    api = get_model(cfg)
    dev = torch.device("cuda")
    params = _to(api.init(torch.Generator().manual_seed(0), device="cpu"),
                 dev)
    eng = _Shadowed(api, Env(dev, torch.bfloat16), params, max_batch=2,
                    max_len=48)
    assert eng._graph is not None
    assert all(not bool(t.any()) for t in eng.cache.values())
    captured = len(eng.outputs)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (5, 12))
    for prompt, budget in zip(prompts, BUDGETS):
        eng.submit(prompt, max_new_tokens=budget)
    done = eng.run()
    assert sorted(r.rid for r in done) == list(range(5))
    assert [len(r.output) for r in sorted(done, key=lambda r: r.rid)] \
        == BUDGETS
    # the replays called no Python: the model ran only at warm-up and capture
    assert len(eng.outputs) == captured
    assert len(eng.timings["decode"]) == eng.ticks
    assert max(eng.logit_err) <= TOL, eng.logit_err


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1])
def test_replay_follows_its_inputs(index):
    """Each replay reads the inputs uploaded before it and chooses the eager
    step's tokens, also on an engine whose device is not the current one."""
    if torch.cuda.device_count() <= index:
        pytest.skip(f"needs {index + 1} CUDA devices")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", index)
    cfg = _tiny("minicpm-2b")
    api = get_model(cfg)
    params = _to(api.init(torch.Generator().manual_seed(0), device="cpu"),
                 dev)
    eng = ServeEngine(api, Env(dev, torch.bfloat16), params, max_batch=2,
                      max_len=48)
    assert eng._graph is not None
    rng = np.random.default_rng(7)
    chosen = set()
    for step in range(8):
        inputs = torch.as_tensor(np.stack(
            [rng.integers(0, cfg.vocab_size, 2), [step, 2 * step]]))
        clone = {k: t.clone() for k, t in eng.cache.items()}
        eng._inputs.copy_(inputs)
        eng._graph.replay()
        got = eng._next.cpu()
        with torch.cuda.device(dev):
            logits, _ = api.decode_step(
                eng.env, params, clone,
                {"tokens": inputs[0][:, None].to(dev),
                 "pos": inputs[1].to(dev)})
        want = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32).cpu()
        assert torch.equal(got, want), step
        chosen.add(tuple(got.tolist()))
    assert len(chosen) > 1
