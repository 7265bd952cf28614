"""Shared helpers of the port's model-family parity tests.

Each case takes a reference config's ``reduced()`` form, draws the
reference's weights with ``jax.random.PRNGKey(seed)``, carries them into the
port with ``params_from_jax`` and runs both packages in fp32 on the CPU on
inputs made with numpy from a seed.  The reference runs as its own tests run
it on the CPU: no Pallas, its dense einsum attention.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models.common import Env as JaxEnv
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import Env, get_model, params_from_jax
from repro_torch.train import AdamState, TrainState
from repro_torch.train.tree import tree_leaves_with_path
from repro_torch.serve import ServeEngine

TOL = 1e-4
CPU = torch.device("cpu")
JENV = JaxEnv(compute_dtype=jnp.float32)
TENV = Env(CPU, torch.float32)


@dataclasses.dataclass
class Pair:
    """One reduced config in both packages, with the same weights."""
    jcfg: object
    tcfg: ModelConfig
    japi: object
    tapi: object
    jparams: dict
    tparams: dict


def make_pair(arch: str, seed: int = 0, **overrides) -> Pair:
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    japi, tapi = jax_get_model(jcfg), get_model(tcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device=CPU, dtype=torch.float32)
    return Pair(jcfg, tcfg, japi, tapi, jparams, tparams)


def close(a, b, tol: float = TOL) -> None:
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def batches(cfg: ModelConfig, tokens: np.ndarray, rng=None):
    """The same prefill batch for both packages: ``tokens`` and, for audio,
    frames (B, encoder_seq, D) drawn from ``rng``; for vlm, patch
    embeddings (B, num_patches, D)."""
    extra = {}
    B = tokens.shape[0]
    if cfg.family == "audio":
        extra["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.family == "vlm":
        extra["patch_embeds"] = rng.normal(size=(B, cfg.num_patches,
                                                 cfg.d_model))
    extra = {k: v.astype(np.float32) for k, v in extra.items()}
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb


def check_prefill_and_decode(p: Pair, *, seed: int = 0, B: int = 2,
                             S: int = 12, steps: int = 3,
                             max_len: int = 20) -> None:
    """Prefill logits and every cache entry, then ``steps`` decode steps at
    ragged positions (the second sequence rewinds), within :data:`TOL`."""
    rng = np.random.default_rng(seed)
    V = p.tcfg.vocab_size
    jb, tb = batches(p.tcfg, rng.integers(0, V, (B, S)).astype(np.int32), rng)
    jl, jc = p.japi.prefill(JENV, p.jparams, jb, max_len)
    tl, tc = p.tapi.prefill(TENV, p.tparams, tb, max_len)
    assert tuple(tl.shape) == (B, 1, V)
    close(tl, jl)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        close(tc[name], jc[name])
    pos = np.array([S, S - 5] + [S] * (B - 2), np.int32)
    for _ in range(steps):
        step = rng.integers(0, V, (B, 1)).astype(np.int32)
        jl, jc = p.japi.decode_step(JENV, p.jparams, jc,
                                    {"tokens": jnp.asarray(step),
                                     "pos": jnp.asarray(pos)})
        tl, tc = p.tapi.decode_step(TENV, p.tparams, tc,
                                    {"tokens": torch.from_numpy(step).long(),
                                     "pos": torch.from_numpy(pos).long()})
        assert tuple(tl.shape) == (B, 1, V)
        close(tl, jl)
        pos = pos + 1
    for name in jc:
        close(tc[name], jc[name])


#: five requests' budgets: with three slots, admission queues and, as the
#: short ones finish, slots go idle while the long ones decode
BUDGETS = [3, 7, 2, 6, 4]


def serve_both(p: Pair, *, max_batch: int = 3, max_len: int = 24,
               prompt_len: int = 10, seed: int = 5):
    """Greedy tokens of five ragged requests through both engines, as
    {rid: tokens}.  The reference engine always allocates a bf16 cache, so
    it is handed an API whose ``init_cache`` makes an fp32 one."""
    prompts = list(np.random.default_rng(seed).integers(
        0, p.tcfg.vocab_size, (len(BUDGETS), prompt_len)))
    japi = dataclasses.replace(
        p.japi, init_cache=lambda batch, max_len, env, dtype=None:
        p.japi.init_cache(batch, max_len, env, jnp.float32))
    engines = {
        "ref": JaxServeEngine(japi, JENV, p.jparams, max_batch=max_batch,
                              max_len=max_len),
        "port": ServeEngine(p.tapi, TENV, p.tparams, max_batch=max_batch,
                            max_len=max_len),
    }
    out = {}
    for name, eng in engines.items():
        for prompt, budget in zip(prompts, BUDGETS):
            eng.submit(prompt, max_new_tokens=budget)
        out[name] = {r.rid: list(r.output) for r in eng.run()}
    assert sorted(out["port"]) == list(range(len(BUDGETS)))
    assert [len(out["port"][i]) for i in range(len(BUDGETS))] == BUDGETS
    return out["ref"], out["port"]


# ---------------------------------------------------------------------------
# Training (tests/test_torch_train_*.py)
# ---------------------------------------------------------------------------

#: one reduced config of each family; the hybrid's shared block runs after
#: layers 2 and 4 of 4 (``attn_period`` 2)
FAMILIES = {"dense": "minicpm-2b", "moe": "moonshot-v1-16b-a3b",
            "vlm": "phi-3-vision-4.2b", "ssm": "mamba2-370m",
            "hybrid": "zamba2-1.2b", "audio": "whisper-large-v3"}
OPT = dict(lr=1e-3, warmup=0, total_steps=10)


def train_batches(p, B=4, S=16, seed=0):
    """The same training batch for both packages: tokens, next-token
    labels, and the family's seeded stand-in inputs."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, p.tcfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = batches(p.tcfg, tok, rng)
    labels = np.roll(tok, -1, axis=1)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels).long()
    return jb, tb



_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def train_state_from_jax(np_state, cfg: ModelConfig, *,
                         device: torch.device = CPU) -> TrainState:
    """The reference's ``TrainState`` (its leaves as numpy arrays) as the
    port's: ``params``, AdamW's ``mu`` and ``nu`` (and, quantized,
    ``nu_scale``) through ``params_from_jax``'s transposition, each in its
    own dtype, and ``step``.  The int8 codes and per-block scales of a
    quantized ``nu`` carry across as they are, since the port blocks each
    leaf along the reference's last axis
    (``repro_torch.models.convert.reference_last_axis``)."""
    def tree(np_tree):
        if np_tree is None:
            return None
        return params_from_jax(np_tree, cfg, device=device,
                               dtype=_TORCH_DTYPES[str(np_tree["embed"].dtype)])
    opt = np_state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=device)
    return TrainState(
        params=tree(np_state.params),
        opt=AdamState(step, tree(opt.mu), tree(opt.nu), tree(opt.nu_scale)))

#: the absolute floor of a leaf whose gradient is zero but for rounding
FLOOR = 1e-8


def compare_trees(got, want_np, cfg, dtype=torch.float32, tol=1e-4,
                  atol=0.0, loose=(), loose_atol=0.0):
    """A port tree against the reference's (numpy leaves) carried into the
    port's layout, leaf by leaf: ``tol`` relative, and ``tol`` absolute at
    the scale of the leaf's largest element where that is under 1, plus
    ``atol`` (``loose_atol`` for the leaves named in ``loose``) and
    :data:`FLOOR`."""
    want = params_from_jax(want_np, cfg, device=CPU, dtype=dtype)
    a, b = tree_leaves_with_path(got), tree_leaves_with_path(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.shape == y.shape, k
        scale = min(1.0, float(y.float().abs().max()))
        extra = loose_atol if k in loose else atol
        np.testing.assert_allclose(x.detach().float().numpy(),
                                   y.float().numpy(), rtol=tol,
                                   atol=tol * scale + extra + FLOOR,
                                   err_msg=k)
