"""The port's MoE FFN and moe decoders against the reference's, on the CPU.

Dispatch (the stable sort by expert, per-expert capacity, the overflow
slot, the un-sort) must be equal, at capacity 1 with collisions too;
``moe_ffn``'s output and aux loss agree within 1e-5; moonshot- and
kimi-shaped reduced models (``cfg.reduced()``: 4 experts, top 2, one
shared expert) agree within 1e-4 on prefill and decode logits and caches,
and their engines' greedy tokens of ragged requests are equal (idle decode
slots count toward capacity, as in the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe

from _torch_parity import JENV, TENV, close, check_prefill_and_decode, \
    make_pair, serve_both

MOE_ARCHS = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]


@pytest.mark.parametrize("capacity", [1, 2, 3, 8])
def test_dispatch_equals_reference(capacity):
    rng = np.random.default_rng(capacity)
    N, k, E, D = 12, 2, 4, 8
    x = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(0, E, N * k).astype(np.int32)
    jbuf, jslot, jvalid = jax_moe._dispatch_local(
        jnp.asarray(x), jnp.asarray(ids), capacity, E, k)
    tbuf, tslot, tvalid = moe._dispatch_local(
        torch.from_numpy(x), torch.from_numpy(ids).long(), capacity, E, k)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    if capacity == 1:                  # collisions: some assignments drop
        assert not tvalid.all()


@pytest.fixture(scope="module")
def moonshot():
    return make_pair("moonshot-v1-16b-a3b")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5, 8.0])
def test_moe_ffn_output_and_aux(moonshot, capacity_factor):
    p = moonshot
    jp = jax.tree.map(lambda a: a[0], p.jparams["blocks"]["moe"])
    tp = p.tparams["blocks"][0]["moe"]
    x = np.random.default_rng(2).normal(
        size=(2, 8, p.tcfg.d_model)).astype(np.float32)
    kw = dict(num_experts=p.tcfg.num_experts,
              experts_per_token=p.tcfg.experts_per_token,
              capacity_factor=capacity_factor)
    jy, jaux = jax_moe.moe_ffn(JENV, jp, jnp.asarray(x), **kw)
    ty, taux = moe.moe_ffn(TENV, tp, torch.from_numpy(x), **kw)
    close(ty, jy, 1e-5)
    close(taux, jaux, 1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_reduced_prefill_and_decode(arch):
    check_prefill_and_decode(make_pair(arch))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_equal_reference(arch):
    ref, port = serve_both(make_pair(arch))
    assert port == ref


def test_init_draws_expert_stacks_in_reference_layout():
    cfg = make_pair("kimi-k2-1t-a32b").tcfg
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                     cfg.num_experts, cfg.shared_experts,
                     dict(device=torch.device("cpu"), dtype=torch.float32))
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert tuple(p["router"].shape) == (E, D)
    assert tuple(p["wg"].shape) == tuple(p["wu"].shape) == (E, D, F)
    assert tuple(p["wd"].shape) == (E, F, D)
    assert float(p["wg"].abs().max()) <= 2.0 * D ** -0.5
    assert float(p["wd"].abs().max()) <= 2.0 * F ** -0.5
    assert tuple(p["shared"]["wg"].shape) == (cfg.shared_experts * F, D)
