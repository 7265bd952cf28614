"""All ten of the reference's architectures in the port, on the CPU.

The configs equal the reference's field for field; the vlm's patch
embeddings replace only the prompt's prefix; the three other dense configs
(minitron-4b, qwen2.5-32b, qwen2-72b: GQA and QKV bias) and phi-3-vision,
in their ``cfg.reduced()`` form, agree with the reference within 1e-4 on
prefill and decode logits and caches, and serve greedy tokens equal to its
engine's; ``python -m repro_torch.launch.serve --device cpu --arch X``
serves each architecture this slice added.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer

from _torch_parity import TENV, batches, check_prefill_and_decode, \
    make_pair, serve_both

DENSE = ["minitron-4b", "qwen2.5-32b", "qwen2-72b"]
NEW = DENSE + ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b",
               "whisper-large-v3", "phi-3-vision-4.2b"]


def test_registry_holds_the_references_archs_in_order():
    assert list(ARCHS) == list(JAX_ARCHS)


@pytest.mark.parametrize("arch", list(JAX_ARCHS))
def test_config_equals_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        JAX_ARCHS[arch])
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(JAX_ARCHS[arch].reduced())


@pytest.mark.parametrize("arch", DENSE + ["phi-3-vision-4.2b"])
def test_reduced_prefill_and_decode(arch):
    check_prefill_and_decode(make_pair(arch))


@pytest.mark.parametrize("arch", DENSE + ["phi-3-vision-4.2b"])
def test_engine_greedy_tokens_equal_reference(arch):
    ref, port = serve_both(make_pair(arch))
    assert port == ref


def test_vlm_patch_embeds_change_only_the_prefix():
    """Layer 0's K/V at a position depend on that position's embedding
    alone: with patch embeddings they move at the first num_patches
    positions and nowhere else."""
    p = make_pair("phi-3-vision-4.2b")
    cfg = p.tcfg
    npatch = cfg.num_patches
    _, tb = batches(cfg, np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32), np.random.default_rng(1))
    _, with_pe = transformer.prefill(TENV, cfg, p.tparams, tb)
    _, without = transformer.prefill(TENV, cfg, p.tparams,
                                     {"tokens": tb["tokens"]})
    for name in ("k", "v"):
        a, b = with_pe[name][0], without[name][0]
        assert torch.equal(a[:, npatch:], b[:, npatch:])
        assert (a[:, :npatch] - b[:, :npatch]).abs().amin(
            dim=(-1, -2)).gt(0).all()


@pytest.mark.parametrize("arch", NEW)
def test_launch_serve_each_new_arch_on_cpu(arch, capsys):
    res = serve_cli.main(["--device", "cpu", "--arch", arch, "--scale", "10m",
                          "--requests", "3", "--prompt-len", "12",
                          "--max-new", "3", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "ServingPlan:" in out and "served 3 requests, 9 tokens" in out
    assert res["device"] == "cpu"
    assert res["requests"] == 3 and res["tokens"] == 9
    assert all(0 <= t < 8192 for r in res["done"] for t in r.output)
