"""The ``hybrid_moe`` family (nemotron-3-nano-30b-a3b) on the CPU: its
configuration, its grouped SSD and dropless MoE against plain
computations, and the whole model against the benchmark's plain float32
reference (``perfbench/reference/hybrid_moe.py``) at a reduced size with
every kind of layer and two groups of B/C.  The reference has no
counterpart in the JAX package, which has no such model.  Tolerances:
the model's logits within ``test_perfbench_reference.py``'s 2e-5 (+ 1e-4
relative) in fp32; the MoE and SSD pieces in fp32 to 1e-5."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import bench, check, weights
from repro_torch import obs
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import HybridMoEConfig
from repro_torch.kernels.moe_grouped import kernel as moe_kernel
from repro_torch.kernels.moe_grouped.ops import grouped_relu2
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference
from repro_torch.models import Env, get_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.ssm import ssm_block
from repro_torch.serve import ServeEngine

ARCH = "nemotron-3-nano-30b-a3b"
CPU = Env(torch.device("cpu"), torch.float32)


def _sizes(cfg):
    spec = bench.load_json(bench.HERE / "configs" / f"{ARCH}.json")["sizes"]
    return {k: getattr(cfg, k) for k in spec}


def _reference_pair(seed=11):
    cfg = get_config(ARCH).reduced()
    s = _sizes(cfg)
    ref = bench.load("reference", "hybrid_moe")
    w = weights.draw(ref.weight_spec(s), seed, "cpu", torch.float32)
    params = bench.load("layouts", "hybrid_moe").port_params(w, s)
    return cfg, s, ref, w, params


# -- the configuration -------------------------------------------------------

def test_param_count_is_the_published_31_58b():
    cfg = get_config(ARCH)
    assert cfg.param_count() == 31_577_940_288
    assert round(cfg.param_count() / 1e9, 2) == 31.58
    # per token: 6 of 128 experts, the shared one and everything else
    expert = 2 * 2688 * 1856
    assert cfg.active_param_count() == cfg.param_count() - 23 * 122 * expert


def test_config_is_the_published_pattern():
    cfg = get_config(ARCH)
    assert isinstance(cfg, HybridMoEConfig) and cfg.family == "hybrid_moe"
    pat = cfg.layer_pattern
    assert (len(pat), pat.count("M"), pat.count("E"), pat.count("*")) == \
        (52, 23, 23, 6)
    assert [i for i, k in enumerate(pat) if k == "*"] == [5, 12, 19, 26, 33,
                                                          42]
    assert cfg.ssm_inner == 4096 != cfg.ssm_expand * cfg.d_model
    # the reference's ten configurations keep the reference's fields
    assert ARCH not in ARCHS
    assert "layer_pattern" not in dataclasses.asdict(get_config("mamba2-370m"))


def test_reduced_has_every_kind_and_two_groups():
    cfg = get_config(ARCH).reduced()
    assert set(cfg.layer_pattern) == set("ME*") and cfg.ssm_groups == 2
    assert cfg.num_layers == len(cfg.layer_pattern)
    assert cfg.num_heads > cfg.num_kv_heads
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(cfg, num_layers=4)


def test_a_mesh_is_refused():
    cfg = get_config(ARCH).reduced()
    meshed = dataclasses.replace(CPU, mesh=object())
    with pytest.raises(ValueError, match="one device"):
        get_model(cfg).init_cache(2, 8, meshed)


def test_cache_holds_each_kind_only_for_its_layers():
    cfg = get_config(ARCH).reduced()
    cache = get_model(cfg).init_cache(3, 24, CPU, dtype=torch.float32)
    nM, nA = cfg.layer_pattern.count("M"), cfg.layer_pattern.count("*")
    nE = cfg.layer_pattern.count("E")
    assert set(cache) == {"k", "v", "state", "conv", "route"}
    assert cache["route"].shape == (nE, 3, 24, cfg.experts_per_token)
    assert cache["k"].shape == (nA, 3, 24, cfg.num_kv_heads, cfg.head_dim)
    assert cache["state"].shape == (nM, 3, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state)
    assert cache["state"].dtype == torch.float32
    d_conv = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    assert cache["conv"].shape == (nM, 3, cfg.ssm_conv_width - 1, d_conv)
    full = get_model(get_config(ARCH)).init_cache(
        64, 1544, Env(torch.device("meta"), torch.bfloat16))
    assert full["k"].shape[0] == 6 and full["state"].shape[0] == 23
    nbytes = sum(t.numel() * t.element_size() for t in full.values())
    assert 3.6e9 < nbytes < 3.8e9          # 3.09 GB state, 0.61 GB K/V
    assert full["route"].numel() * 2 == 23 * 64 * 1544 * 6 * 2   # 27 MB


# -- grouped SSD ---------------------------------------------------------------

def _ssd_inputs(seed, Bt, S, H, P, N, G):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(Bt, S, H, P, generator=g),
            torch.rand(Bt, S, H, generator=g) * 0.2 + 0.01,
            -(torch.rand(H, generator=g) * 1.5 + 0.5),
            torch.randn(Bt, S, G, N, generator=g),
            torch.randn(Bt, S, G, N, generator=g),
            torch.randn(Bt, H, P, N, generator=g))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("with_init", [False, True])
def test_grouped_ssd_equals_one_group_scans(G, with_init):
    x, dt, A, B, C, init = _ssd_inputs(G, 2, 45, 8, 4, 6, G)
    init = init if with_init else None
    y, st = ssd_reference(x, dt, A, B, C, chunk=16, init_state=init)
    Hg = 8 // G
    for g in range(G):
        h = slice(g * Hg, (g + 1) * Hg)
        y1, s1 = ssd_reference(x[:, :, h], dt[:, :, h], A[h], B[:, :, g],
                               C[:, :, g], chunk=16,
                               init_state=None if init is None else init[:, h])
        torch.testing.assert_close(y[:, :, h], y1, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(st[:, h], s1, rtol=1e-5, atol=1e-5)


def test_one_group_keeps_its_bits():
    """(Bt, S, 1, N) takes the one-group path: the same bits as (Bt, S, N),
    which is the code the reference's models run, unchanged."""
    x, dt, A, B, C, init = _ssd_inputs(3, 2, 40, 4, 8, 16, 1)
    one = ssd_reference(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=16,
                        init_state=init)
    four = ssd_reference(x, dt, A, B, C, chunk=16, init_state=init)
    assert all(torch.equal(a, b) for a, b in zip(one, four))
    via_ops = ssd_ops.ssd_scan(x, dt, A, B[:, :, 0], C[:, :, 0], chunk=16,
                               init_state=init)
    assert all(torch.equal(a, b) for a, b in zip(one, via_ops))


def test_grouped_decode_update_equals_the_scan():
    """Prefill, then single-token updates through the cache, equal one
    scan over the whole sequence (grouped B/C, gate-first norm)."""
    cfg = get_config(ARCH).reduced()
    _, _, _, _, params = _reference_pair()
    p = params["blocks"][0]["ssm"]
    x = torch.randn(2, 20, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    whole, _ = ssm_block(CPU, p, x, cfg)
    first, (st, conv) = ssm_block(CPU, p, x[:, :12], cfg)
    outs = [first]
    for t in range(12, 20):
        o, (st, conv) = ssm_block(CPU, p, x[:, t:t + 1], cfg, cache=(st, conv))
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=1e-5,
                               atol=1e-5)


def test_gate_first_norm_is_per_group():
    """Scaling one group's gated channels leaves the others' output."""
    cfg = get_config(ARCH).reduced()
    y = torch.randn(1, 3, cfg.ssm_inner)
    z = torch.randn(1, 3, cfg.ssm_inner)
    from repro_torch.models.ssm import _gated_group_norm
    a = _gated_group_norm(y, z, torch.zeros(cfg.ssm_inner), 2, 1e-5)
    y2 = y.clone()
    y2[..., :cfg.ssm_inner // 2] *= 7.0
    b = _gated_group_norm(y2, z, torch.zeros(cfg.ssm_inner), 2, 1e-5)
    half = cfg.ssm_inner // 2
    torch.testing.assert_close(a[..., half:], b[..., half:])
    torch.testing.assert_close(a[..., :half], b[..., :half], rtol=1e-4,
                               atol=1e-4)


# -- the dropless MoE ------------------------------------------------------------

def _moe_params(seed, D=16, F=8, E=8, Fs=12, bias_std=0.05):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(E, D, generator=g) / D ** 0.5,
            "bias": torch.randn(E, generator=g) * bias_std,
            "wu": torch.randn(E, D, F, generator=g) / D ** 0.5,
            "wd": torch.randn(E, F, D, generator=g) / F ** 0.5,
            "shared": {"wu": torch.randn(Fs, D, generator=g) / D ** 0.5,
                       "wd": torch.randn(D, Fs, generator=g) / Fs ** 0.5}}


def _direct(p, x, k, scale):
    """Token by token: the chosen experts' relu^2 outputs, weighted, plus
    the shared expert."""
    xf = x.reshape(-1, x.shape[-1])
    out = []
    for t in xf:
        s = torch.sigmoid(p["router"] @ t)
        ids = torch.topk(s + p["bias"], k).indices
        w = s[ids] / s[ids].sum() * scale
        y = sum(w[j] * (torch.relu(t @ p["wu"][e]).square() @ p["wd"][e])
                for j, e in enumerate(ids.tolist()))
        y = y + p["shared"]["wd"] @ torch.relu(p["shared"]["wu"] @ t).square()
        out.append(y)
    return torch.stack(out).reshape(x.shape)


@pytest.mark.parametrize("n", [1, 3, 17, 64])
def test_dropless_moe_equals_the_direct_sum(n):
    p = _moe_params(n)
    x = torch.randn(1, n, 16, generator=torch.Generator().manual_seed(9))
    y, ids = moe_mod.moe_dropless(CPU, p, x, num_experts=8,
                                  experts_per_token=3, routed_scale=2.5)
    torch.testing.assert_close(y, _direct(p, x, 3, 2.5), rtol=1e-5,
                               atol=1e-5)
    s = torch.sigmoid(x.reshape(-1, 16) @ p["router"].T) + p["bias"]
    assert torch.equal(ids.reshape(-1, 3), torch.topk(s, 3).indices)


@pytest.mark.parametrize("n", [1, 5, 40, 300])
def test_no_row_is_dropped(n):
    """Every token sent to the same three experts (a bias that outweighs
    the scores): each expert takes all n rows, which a capacity of
    ceil(n k 1.25 / E) would cut, and the sum is still the direct one."""
    p = _moe_params(n)
    p["bias"] = torch.tensor([9.0, 8.0, 7.0] + [0.0] * 5)
    x = torch.randn(2, n, 16, generator=torch.Generator().manual_seed(2))
    w, ids = moe_mod.route_sigmoid(x.reshape(-1, 16), p["router"], p["bias"],
                                   3, 1.0)
    assert set(ids.reshape(-1).tolist()) == {0, 1, 2}
    y, _ = moe_mod.moe_dropless(CPU, p, x, num_experts=8,
                                experts_per_token=3, routed_scale=1.0)
    torch.testing.assert_close(y, _direct(p, x, 3, 1.0), rtol=1e-5,
                               atol=1e-5)
    assert bool((y - _direct({**p, "wd": torch.zeros_like(p["wd"])}, x, 3,
                             1.0)).abs().amax(-1).gt(0).all())


def test_bias_chooses_but_does_not_weigh():
    p = _moe_params(5)
    xf = torch.randn(50, 16, generator=torch.Generator().manual_seed(6))
    w0, ids0 = moe_mod.route_sigmoid(xf, p["router"], torch.zeros(8), 3, 2.5)
    bias = torch.linspace(-0.3, 0.3, 8)
    w1, ids1 = moe_mod.route_sigmoid(xf, p["router"], bias, 3, 2.5)
    assert not torch.equal(ids0, ids1)
    s = torch.sigmoid(xf @ p["router"].T)
    for w, ids in ((w0, ids0), (w1, ids1)):
        chosen = s.gather(1, ids)
        torch.testing.assert_close(w, chosen / chosen.sum(-1, keepdim=True)
                                   * 2.5)
        torch.testing.assert_close(w.sum(-1), torch.full((50,), 2.5))


def test_grouped_relu2_plain_runs_each_expert_on_its_rows():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, 8, generator=g)
    wu, wd = torch.randn(4, 8, 6, generator=g), torch.randn(4, 6, 8, generator=g)
    ids = torch.tensor([2, 0, 2, 3, 2, 1, 0, 0, 2, 3])      # k = 2
    order = torch.argsort(ids, stable=True)
    offsets = torch.tensor([0, 3, 4, 8, 10])
    scale = torch.rand(10, generator=g)
    out = grouped_relu2(x, order // 2, order, scale[order], offsets, wu, wd)
    for a in range(10):
        e, t = int(ids[a]), a // 2
        want = scale[a] * (torch.relu(x[t] @ wu[e]).square() @ wd[e])
        torch.testing.assert_close(out[a], want)
    assert moe_kernel.rows_per_program(384, 128) == 16
    assert moe_kernel.rows_per_program(192 * 6, 128) == 16
    assert moe_kernel.rows_per_program(512 * 6, 128) == 32
    assert moe_kernel.rows_per_program(4096 * 6, 128) == 64


def test_the_kernel_refuses_cpu_tensors():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        moe_kernel.grouped_relu2_fwd(x, *([torch.zeros(1)] * 6))


# -- the whole model against the plain reference ----------------------------------

def test_prefill_then_decode_match_the_reference():
    cfg, s, ref, w, params = _reference_pair()
    api = get_model(cfg)
    seq = torch.randint(0, cfg.vocab_size, (40,),
                        generator=torch.Generator().manual_seed(3))
    P = 33
    logits, cache = api.prefill(CPU, params, {"tokens": seq[None, :P]},
                                max_len=48)
    got = [logits[0, -1]]
    for t in range(P, len(seq)):
        lg, cache = api.decode_step(CPU, params, cache, {
            "tokens": seq[None, t:t + 1], "pos": torch.tensor([t])})
        got.append(lg[0, -1])
    want = ref.logits(w, s, seq, list(range(P - 1, len(seq))))
    assert torch.allclose(torch.stack(got), want, atol=2e-5, rtol=1e-4), \
        (torch.stack(got) - want).abs().max()
    full, aux = api.forward(CPU, params, {"tokens": seq[None]})
    torch.testing.assert_close(full[0, P - 1:], want, rtol=1e-4, atol=2e-5)
    assert float(aux) == 0.0


def test_ragged_engine_serves_the_reference_argmax():
    """Five requests of different lengths on two slots (freed slots taken
    by later ones): every served token is the reference's best."""
    cfg, s, ref, w, params = _reference_pair(seed=12)
    eng = ServeEngine(get_model(cfg), CPU, params, max_batch=2, max_len=40)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 14, 5, 11, 7)]
    budgets = [6, 3, 8, 4, 5]
    for pr, b in zip(prompts, budgets):
        eng.submit(pr, max_new_tokens=b)
    done = sorted(eng.run(), key=lambda r: r.rid)
    assert [len(r.output) for r in done] == budgets
    served = [check.Served(pr, r.output) for pr, r in zip(prompts, done)]
    assert check.logit_gap(ref, w, s, served, "cpu") == 0.0


def test_spans_and_their_rows():
    cfg, _, _, _, params = _reference_pair()
    api = get_model(cfg)
    tracer = obs.Tracer(enabled=True)
    saved = obs.set_tracer(tracer)
    try:
        api.prefill(CPU, params, {"tokens": torch.zeros(1, 7, dtype=torch.long)},
                    max_len=16)
    finally:
        obs.set_tracer(saved)
    names = [r.name for r in tracer.spans if r.name.startswith("block.")]
    kinds = {"M": "block.ssm", "E": "block.moe", "*": "block.attn"}
    assert names == [kinds[k] for k in cfg.layer_pattern]
    moe_rows = [r.attr_dict()["rows"] for r in tracer.spans
                if r.name == "block.moe"]
    assert moe_rows == [7 * cfg.experts_per_token] * cfg.layer_pattern.count("E")
