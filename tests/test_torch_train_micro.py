"""Microbatched train steps and training itself, the port against the
reference (``repro.train``) on reduced configs in fp32 on the CPU.

* ``microbatches=2`` against the reference's ``microbatches=2`` (one step:
  new params, moments and the microbatches' mean metrics) within 1e-4 as
  ``test_torch_train_step.py`` holds one step, and against the port's own
  ``microbatches=1`` within 5e-3 (the reference's own check,
  tests/test_train.py: gradients average linearly, the logged losses are
  means over microbatches);
* training reduces the loss: reduced minicpm memorizes one batch, its loss
  falling by more than 0.5 in 40 steps (tests/test_train.py).
"""

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, FAMILIES, JENV, OPT, TENV, close,
                           compare_trees, make_pair, train_batches,
                           train_state_from_jax)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import Env, get_model
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_train_step)
from repro_torch.train.tree import tree_leaves_with_path


@pytest.mark.parametrize("family", list(FAMILIES))
def test_microbatched_step_matches_reference(family):
    import jax
    from repro.train import (AdamWConfig as JaxAdamWConfig,
                             init_train_state as jax_init_train_state,
                             make_train_step as jax_make_train_step)
    p = make_pair(FAMILIES[family])
    jb, tb = train_batches(p, seed=2)
    jcfg, tcfg = JaxAdamWConfig(**OPT), AdamWConfig(**OPT)
    jstate = jax_init_train_state(p.japi, jax.random.PRNGKey(0), jcfg)
    jnew, jm = jax.jit(jax_make_train_step(p.japi, JENV, jcfg,
                                           microbatches=2))(jstate, jb)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), p.tcfg,
                                 device=CPU)
    new, tm = make_train_step(p.tapi, TENV, tcfg, microbatches=2)(state, tb)
    for k in jm:
        close(tm[k], jm[k])
    jnew = jax.tree.map(np.asarray, jnew)
    about_zero = {k for k, _ in tree_leaves_with_path(new.params)
                  if k.endswith("/bk")} if family == "audio" else set()
    compare_trees(new.params, jnew.params, p.tcfg, atol=1e-4 * tcfg.lr,
                  loose=about_zero, loose_atol=tcfg.lr * 1.01)
    compare_trees(new.opt.mu, jnew.opt.mu, p.tcfg)
    compare_trees(new.opt.nu, jnew.opt.nu, p.tcfg)

    # against the port's own full-batch step (rtol 5e-3, as the reference),
    # from the same state drawn anew (a step updates its state in place)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), p.tcfg,
                                 device=CPU)
    one, _ = make_train_step(p.tapi, TENV, tcfg)(state, tb)
    for (k, a), (_, b) in zip(tree_leaves_with_path(new.params),
                              tree_leaves_with_path(one.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3,
                                   atol=5e-3, err_msg=k)


def test_training_reduces_loss():
    """40 steps on one memorized batch of reduced minicpm (bf16 compute,
    remat, WSD) drop the loss by more than 0.5."""
    cfg = get_config("minicpm-2b").reduced()
    api = get_model(cfg)
    env = Env(CPU)
    opt = AdamWConfig(lr=3e-3, warmup=5, total_steps=100, schedule="wsd")
    state = init_train_state(api, torch.Generator().manual_seed(0), opt,
                             device="cpu")
    step = make_train_step(api, env, opt)
    src = SyntheticTokens(32, 8, cfg.vocab_size, seed=0)
    batch = {k: torch.from_numpy(v).long() for k, v in src.next().items()}
    losses = []
    for _ in range(40):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_remat_changes_nothing_but_memory():
    """With and without ``Env.remat`` one step gives the same bits."""
    p = make_pair("zamba2-1.2b")
    _, tb = train_batches(p, seed=3)
    out = []
    for remat in (True, False):
        env = Env(CPU, torch.float32, remat=remat)
        state = init_train_state(p.tapi, torch.Generator().manual_seed(1),
                                 AdamWConfig(**OPT), device="cpu")
        new, m = make_train_step(p.tapi, env, AdamWConfig(**OPT))(state, tb)
        out.append((new, m))
    for (_, a), (_, b) in zip(tree_leaves_with_path(out[0]),
                              tree_leaves_with_path(out[1])):
        assert torch.equal(a, b)
