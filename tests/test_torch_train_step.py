"""The port's training forward, loss and train step against the
reference's (``repro.train``), per model family.

Each family's reduced config (``_torch_parity.make_pair``: the reference's
weights carried into the port) runs in fp32 on the CPU, the reference as
its own tests run it (no Pallas, remat on), on token batches made with
numpy from a seed (vlm adds seeded patch embeddings, audio seeded frames).
Held within 1e-4 (relative, and absolute at the scale of the leaf's
largest element where that is under 1, with a floor of 1e-8 for a leaf
whose gradient is zero but for rounding: whisper's attention key biases,
which softmax cancels), the tolerance of the port's other family
tests:

* the loss, its metrics and every gradient leaf of ``make_loss_fn``
  against ``jax.value_and_grad`` of the reference's;
* one ``make_train_step`` step: new params, ``mu``, ``nu`` and metrics.
  AdamW's first step moves each param by about ``lr * g / (|g| + eps)``,
  which is insensitive to a last-bit difference in ``g`` except where
  ``|g|`` is near ``eps``; the updated params are held at 1e-4 of ``lr``
  beyond the 1e-4 relative tolerance.  A leaf whose gradient is about zero
  in both packages (``|mu|`` under 1e-9 after the step: whisper's
  attention key biases) can move by up to ``lr`` in one and not in the
  other; its params are held at ``lr`` (and weight decay's share), its
  moments at the floor.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, FAMILIES, JENV, OPT, TENV, close,
                           compare_trees, make_pair, train_batches,
                           train_state_from_jax)
from repro_torch.models import params_from_jax
from repro_torch.train import AdamWConfig, make_loss_fn, make_train_step
from repro_torch.train.train_step import _working_copy, value_and_grad
from repro_torch.train.tree import tree_leaves_with_path

@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    import jax
    from repro.train import make_loss_fn as jax_make_loss_fn
    p = make_pair(FAMILIES[family])
    jb, tb = train_batches(p)
    jloss = jax_make_loss_fn(p.japi, JENV)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        p.jparams, jb)
    (tl, tm), tg = value_and_grad(make_loss_fn(p.tapi, TENV),
                                  _working_copy(p.tparams, torch.float32), tb)
    close(tl, jl)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        close(tm[k], jm[k])
    if family == "moe":
        assert float(tm["aux_loss"]) > 0
    compare_trees(tg, jax.tree.map(np.asarray, jg), p.tcfg)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_train_step_matches_reference(family):
    import jax
    from repro.train import (AdamWConfig as JaxAdamWConfig,
                             init_train_state as jax_init_train_state,
                             make_train_step as jax_make_train_step)
    p = make_pair(FAMILIES[family])
    jb, tb = train_batches(p, seed=1)
    jcfg, tcfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    jstate = jax_init_train_state(p.japi, jax.random.PRNGKey(0), jcfg)
    jnew, jm = jax.jit(jax_make_train_step(p.japi, JENV, jcfg))(jstate, jb)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), p.tcfg,
                                 device=CPU)
    new, tm = make_train_step(p.tapi, TENV, tcfg)(state, tb)
    assert int(new.opt.step) == 1
    for k in jm:
        close(tm[k], jm[k])
    jnew = jax.tree.map(np.asarray, jnew)
    mu = params_from_jax(jnew.opt.mu, p.tcfg, device=CPU, dtype=torch.float32)
    about_zero = {k for k, m in tree_leaves_with_path(mu)
                  if float(m.abs().max()) < 1e-9}
    # softmax cancels a bias added to every key: whisper's six ``bk``
    assert about_zero == ({k for k, _ in tree_leaves_with_path(mu)
                           if k.endswith("/bk")} if family == "audio"
                          else set())
    compare_trees(new.params, jnew.params, p.tcfg, atol=1e-4 * tcfg.lr,
                  loose=about_zero, loose_atol=tcfg.lr * 1.01)
    compare_trees(new.opt.mu, jnew.opt.mu, p.tcfg)
    compare_trees(new.opt.nu, jnew.opt.nu, p.tcfg)


@pytest.mark.parametrize("capacity_factor", [0.5, 8.0], ids=["drops", "roomy"])
def test_moe_grads_match_reference(capacity_factor):
    """``moe_ffn`` under autograd: the gradients of its output and aux
    loss with respect to the tokens and every weight, with assignments
    dropped at capacity and without, within 1e-5 (``moe_ffn``'s own
    tolerance in test_torch_moe.py).  The top-1 one-hot of the aux loss
    carries no gradient, in both packages."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jax_moe
    from repro_torch.models import moe
    p = make_pair("moonshot-v1-16b-a3b")
    jp = jax.tree.map(lambda a: a[0], p.jparams["blocks"]["moe"])
    tp = p.tparams["blocks"][0]["moe"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, p.tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(num_experts=p.tcfg.num_experts,
              experts_per_token=p.tcfg.experts_per_token,
              capacity_factor=capacity_factor)

    def jloss(params, x):
        y, aux = jax_moe.moe_ffn(JENV, params, x, **kw)
        return jnp.sum(y * w) + 0.01 * aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tparams = _working_copy(tp, torch.float32)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(TENV, tparams, tx, **kw)
    (torch.sum(y * torch.from_numpy(w)) + 0.01 * aux).backward()
    close(tx.grad, jgx, 1e-5)
    want = {"router": np.asarray(jgp["router"]).T,
            **{n: np.asarray(jgp[n]) for n in ("wg", "wu", "wd")},
            **{f"shared/{n}": np.asarray(jgp["shared"][n]).T
               for n in ("wg", "wu", "wd")}}
    got = dict(tree_leaves_with_path(tparams))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        close(got[k].grad, v, 1e-5)


def test_moe_dropped_assignments_take_no_gradient():
    """The overflow row takes every dropped write and is sliced off, so a
    token gets gradient through the dispatch once per assignment kept."""
    from repro_torch.models import moe
    rng = np.random.default_rng(5)
    N, k, E, D = 12, 2, 4, 8
    x = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    x.requires_grad_()
    ids = torch.from_numpy(rng.integers(0, E, N * k)).long()
    buf, _, valid = moe._dispatch_local(x, ids, 1, E, k)
    buf.sum().backward()
    kept = valid.reshape(N, k).sum(dim=1).float()
    assert not valid.all()
    assert torch.equal(x.grad, kept[:, None].expand(N, D))
