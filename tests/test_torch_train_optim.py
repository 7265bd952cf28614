"""The port's loss, schedules and AdamW against the reference's
(``repro.train``), on the same numpy-made inputs, and the reference's own
optimizer checks run on the port.

Tolerances, and why:

* ``next_token_loss`` and its metrics: 1e-6 (fp32 logsumexp both sides);
* the schedules: 1e-6 (float32 arithmetic both sides; ``cos`` and ``**``
  may differ in the last bit);
* AdamW over ten steps on a reduced model's tree (transposed projections,
  the embedding, MoE expert stacks and the router, norms), three ways.
  The global gradient norm sums the leaves in another order (the reference
  sums stacked layers, the port one layer at a time) and XLA fuses some
  multiply-adds, so the moments differ in the last bits:
  - fp32 moments and the scales of a quantized ``nu``: 1e-6 relative;
  - a bf16 ``mu``: 2**-7 relative plus 2**-7 of the leaf's largest
    magnitude (one bf16 unit in the last place: a last-bit difference can
    round either way, and where ``b1 * mu + (1 - b1) * g`` nearly cancels
    the absolute difference stays at the scale of the leaf);
  - the int8 codes of a quantized ``nu`` (block 64, along the reference's
    last axis): equal but for at most 1 in 10^4 codes, each off by one
    (a last-bit difference across a rounding boundary);
  - the params: 1e-6 relative plus, where ``mu`` is bf16 or ``nu`` int8,
    1e-2 of the step size ``lr`` for each step taken (one flipped unit
    moves one element's update by under 1% of ``lr``, and the moment keeps
    the difference for the steps after).
"""

import numpy as np
import pytest
import torch

from repro_torch.models import params_from_jax
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, get_schedule,
                               next_token_loss, wsd_schedule)
from repro_torch.train.optimizer import global_norm
from repro_torch.train.tree import tree_leaves_with_path

CPU = torch.device("cpu")


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_next_token_loss_matches_reference(masked):
    import jax.numpy as jnp
    from repro.train import next_token_loss as jloss
    rng = np.random.default_rng(0)
    B, S, V = 3, 7, 50
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    # make some predictions right, so that accuracy is not zero
    labels[:, :3] = logits[:, :3].argmax(-1)
    mask = (rng.uniform(size=(B, S)) < 0.6).astype(np.float32) \
        if masked else None
    jl, jm = jloss(jnp.asarray(logits), jnp.asarray(labels),
                   None if mask is None else jnp.asarray(mask))
    tl, tm = next_token_loss(torch.from_numpy(logits),
                             torch.from_numpy(labels).long(),
                             None if mask is None else torch.from_numpy(mask))
    _close(tl, jl, 1e-6, 1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], 1e-6, 1e-6)
    assert float(tm["accuracy"]) > 0


def test_next_token_loss_bf16_logits_and_empty_mask():
    """bf16 logits are widened to fp32 first; an all-zero mask divides by
    one, not zero."""
    logits = torch.randn(2, 5, 11, generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, 11, (2, 5),
                           generator=torch.Generator().manual_seed(2))
    a, _ = next_token_loss(logits.bfloat16(), labels)
    b, _ = next_token_loss(logits.bfloat16().float(), labels)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    zero, m = next_token_loss(logits, labels, torch.zeros(2, 5))
    assert float(zero) == 0.0 and float(m["accuracy"]) == 0.0


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(base_lr=3e-4, warmup=10, total=100)),
    ("wsd", dict(base_lr=1e-2, warmup=7, total=100)),
    ("cosine_min", dict(base_lr=1.0, warmup=5, total=90, min_frac=0.2)),
    ("wsd_decay", dict(base_lr=1.0, warmup=10, total=100, decay_frac=0.2)),
])
def test_schedules_match_reference(name, kw):
    import jax.numpy as jnp
    from repro.train import cosine_schedule as jcos, wsd_schedule as jwsd
    jfn = (jwsd if name.startswith("wsd") else jcos)(**kw)
    tfn = (wsd_schedule if name.startswith("wsd") else cosine_schedule)(**kw)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jfn(jnp.asarray(steps)))
    got = tfn(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6, 1e-6)


def test_get_schedule_names():
    for name in ("wsd", "cosine", "anything-else"):
        got = get_schedule(name, 1.0, 5, 50)(torch.tensor(45, dtype=torch.int32))
        ref = (wsd_schedule if name == "wsd" else cosine_schedule)(1.0, 5, 50)
        assert torch.equal(got, ref(torch.tensor(45)))


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------

VARIANTS = {
    "fp32": ({}, {}),
    "bf16_mu": ({"mu_dtype": "bfloat16"}, {"mu_dtype": torch.bfloat16}),
    "int8_nu": ({"quantize_nu": True, "quant_block": 64},
                {"quantize_nu": True, "quant_block": 64}),
}


def _leaves(tree):
    return tree_leaves_with_path(tree)


def _compare(got, want, check):
    """``check(path, got_leaf, want_leaf)`` over two trees of the port's
    layout, leaf by leaf."""
    a, b = _leaves(got), _leaves(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype, k
        check(k, x, y)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_adamw_matches_reference_over_ten_steps(variant):
    import jax
    import jax.numpy as jnp
    from _torch_parity import make_pair
    from repro.train import (AdamWConfig as JaxAdamWConfig,
                             adamw_init as jinit, adamw_update as jupdate)
    jkw, tkw = VARIANTS[variant]
    jkw = {k: getattr(jnp, v) if k == "mu_dtype" else v
           for k, v in jkw.items()}
    p = make_pair("moonshot-v1-16b-a3b")        # every kind of leaf
    common = dict(lr=1e-2, warmup=3, total_steps=20, clip_norm=1.0)
    jcfg, tcfg = JaxAdamWConfig(**common, **jkw), AdamWConfig(**common, **tkw)
    jp, tp = p.jparams, p.tparams
    js, ts = jinit(jp, jcfg), adamw_init(tp, tcfg)
    jupd = jax.jit(lambda g, s, params: jupdate(g, s, params, jcfg))
    rng = np.random.default_rng(0)
    for i in range(10):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 0.1 * (1 + i)).astype(
                np.float32), jax.tree.map(np.asarray, jp))
        jp, js, jm = jupd(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tm = adamw_update(
            params_from_jax(grads, p.tcfg, device=CPU, dtype=torch.float32),
            ts, tp, tcfg)
    assert int(ts.step) == int(js.step) == 10
    for k in ("grad_norm", "lr"):
        _close(tm[k], jm[k], 1e-6, 0)
    assert float(tm["grad_norm"]) > tcfg.clip_norm        # clipping is on

    def carried(tree, dtype):
        return params_from_jax(jax.tree.map(np.asarray, tree), p.tcfg,
                               device=CPU, dtype=dtype)
    step_atol = 0.0 if variant == "fp32" else 1e-2 * tcfg.lr * 10
    _compare(tp, carried(jp, torch.float32),
             lambda k, x, y: _close(x, y, 1e-6, step_atol + 1e-7))
    mu_dtype = tkw.get("mu_dtype", torch.float32)
    if mu_dtype == torch.bfloat16:
        _compare(ts.mu, carried(js.mu, mu_dtype), lambda k, x, y: _close(
            x, y, 2.0 ** -7, 2.0 ** -7 * float(y.float().abs().max())))
    else:
        _compare(ts.mu, carried(js.mu, mu_dtype),
                 lambda k, x, y: _close(x, y, 1e-6, 1e-9))
    if not tcfg.quantize_nu:
        assert ts.nu_scale is None
        _compare(ts.nu, carried(js.nu, torch.float32),
                 lambda k, x, y: _close(x, y, 1e-6, 1e-12))
        return
    _compare(ts.nu_scale, carried(js.nu_scale, torch.float32),
             lambda k, x, y: _close(x, y, 1e-6, 0))
    off = []

    def codes(k, x, y):
        diff = (x.int() - y.int()).abs()
        assert int(diff.max()) <= 1, k
        off.append((int((diff > 0).sum()), x.numel()))
    _compare(ts.nu, carried(js.nu, torch.int8), codes)
    n_off, n = map(sum, zip(*off))
    assert n_off <= n * 1e-4, (n_off, n)


def test_quantized_nu_blocks_follow_the_reference_layout():
    """A transposed projection is blocked along its dim 0 (the reference's
    last axis), everything else along its last axis; the codes and scales
    have the shapes the reference's carry to after the transposition."""
    params = {"embed": torch.zeros(300, 70), "blocks": [{
        "attn": {"wq": torch.zeros(130, 70)},
        "moe": {"wg": torch.zeros(3, 70, 90)}, "ln1": torch.zeros(70)}]}
    st = adamw_init(params, AdamWConfig(quantize_nu=True, quant_block=64))
    shapes = {k: (tuple(v.shape), tuple(s.shape)) for (k, v), (_, s)
              in zip(_leaves(st.nu), _leaves(st.nu_scale))}
    assert shapes == {
        "embed": ((300, 128), (300, 2)),
        "blocks/0/attn/wq": ((192, 70), (3, 70)),
        "blocks/0/moe/wg": ((3, 70, 128), (3, 70, 2)),
        "blocks/0/ln1": ((128,), (2,))}
    assert all(v.dtype == torch.int8 for _, v in _leaves(st.nu))


def test_update_writes_into_the_old_tensors():
    """The new params and moments are the old tensors, updated; the step
    count is a new tensor."""
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(5, 4, generator=gen),
              "b": [torch.randn(7, generator=gen)]}
    grads = {"w": torch.randn(5, 4, generator=gen),
             "b": [torch.randn(7, generator=gen)]}
    cfg = AdamWConfig(lr=0.1, warmup=0, quantize_nu=True, quant_block=4,
                      mu_dtype=torch.bfloat16)
    before = {"w": params["w"].clone(), "b": [params["b"][0].clone()]}
    state = adamw_init(params, cfg)
    new, new_state, _ = adamw_update(grads, state, params, cfg)
    assert new["w"] is params["w"] and new["b"][0] is params["b"][0]
    for name in ("mu", "nu", "nu_scale"):
        assert getattr(new_state, name)["w"] is getattr(state, name)["w"]
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert not torch.equal(new["w"], before["w"])


# ---------------------------------------------------------------------------
# The reference's own optimizer checks (tests/test_train.py), on the port
# ---------------------------------------------------------------------------

def test_wsd_schedule_shape():
    lr = wsd_schedule(1.0, warmup=10, total=100, decay_frac=0.2)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(50))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(99))) < 0.1


def test_cosine_schedule_monotone_decay():
    lr = cosine_schedule(1.0, warmup=5, total=100)
    vals = [float(lr(torch.tensor(s))) for s in (5, 30, 60, 99)]
    assert vals == sorted(vals, reverse=True)


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup=0, total_steps=200, weight_decay=0.0,
                      clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    target = torch.tensor([1.0, 1.0])
    for _ in range(150):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(grads, state, params, cfg)
    _close(params["w"], target, 0, 0.05)


def test_quantized_nu_tracks_exact():
    exact_cfg = AdamWConfig(lr=0.05, warmup=0, total_steps=100,
                            weight_decay=0.0)
    quant_cfg = AdamWConfig(lr=0.05, warmup=0, total_steps=100,
                            weight_decay=0.0, quantize_nu=True,
                            quant_block=64)
    params_e = {"w": torch.linspace(-1, 1, 256)}
    params_q = {"w": torch.linspace(-1, 1, 256)}
    se, sq = adamw_init(params_e, exact_cfg), adamw_init(params_q, quant_cfg)
    rng = np.random.default_rng(0)
    for _ in range(20):
        g = {"w": torch.from_numpy(rng.normal(size=256).astype(np.float32))}
        params_e, se, _ = adamw_update(g, se, params_e, exact_cfg)
        params_q, sq, _ = adamw_update(g, sq, params_q, quant_cfg)
    assert float((params_e["w"] - params_q["w"]).abs().max()) < 0.2

    cfg = AdamWConfig(lr=0.1, warmup=0, total_steps=200, weight_decay=0.0,
                      clip_norm=100.0, quantize_nu=True, quant_block=64,
                      mu_dtype=torch.bfloat16)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    target = torch.tensor([1.0, 1.0])
    for _ in range(150):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(grads, state, params, cfg)
    _close(params["w"], target, 0, 0.1)


def test_grad_clipping_caps_norm():
    cfg = AdamWConfig(lr=0.0, warmup=0, total_steps=10, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params, cfg)
    _, _, metrics = adamw_update({"w": torch.full((4,), 100.0)}, state,
                                 params, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm({"a": torch.full((4,), 100.0),
                              "b": [torch.zeros(3)]})) == pytest.approx(200.0)
