"""The port's continuous-batching engine against the reference's, on the CPU.

Same weights (the reference init through ``params_from_jax``), same prompts
made with numpy from a seed, fp32 compute: greedy tokens must be equal.
The reference engine always allocates a bf16 cache, so it is handed an API
whose ``init_cache`` makes an fp32 one; nothing in ``repro`` changes.
Five requests on two slots with different budgets make admission queue
and decode positions ragged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import transformer as jax_transformer
from repro.models.common import Env as JaxEnv
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.distributed.mesh import Mesh
from repro_torch.launch import serve as serve_cli
from repro_torch.models import Env, get_model, params_from_jax
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import decode_graphed

SMALL = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
             head_dim=32, d_ff=256, vocab_size=512, name="minicpm-tiny")
BUDGETS = [3, 6, 2, 5, 4]


def _serve(engine, prompts):
    for prompt, budget in zip(prompts, BUDGETS):
        engine.submit(prompt, max_new_tokens=budget)
    done = engine.run()
    return {r.rid: list(r.output) for r in done}


def test_greedy_tokens_equal_reference():
    jcfg = dataclasses.replace(jax_get_config("minicpm-2b"), **SMALL)
    tcfg = dataclasses.replace(get_config("minicpm-2b"), **SMALL)
    japi = jax_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device=torch.device("cpu"), dtype=torch.float32)
    prompts = list(np.random.default_rng(5).integers(0, 512, (5, 10)))

    japi = dataclasses.replace(
        japi, init_cache=lambda batch, max_len, env, dtype=None:
        jax_transformer.init_cache(jcfg, batch, max_len, env, jnp.float32))
    ref = _serve(JaxServeEngine(japi, JaxEnv(compute_dtype=jnp.float32),
                                jparams, max_batch=2, max_len=24), prompts)
    out = _serve(ServeEngine(get_model(tcfg),
                             Env(torch.device("cpu"), torch.float32),
                             tparams, max_batch=2, max_len=24), prompts)
    assert sorted(out) == list(range(5))
    assert [len(out[i]) for i in range(5)] == BUDGETS
    assert out == ref


def test_engine_cache_lives_on_device_in_compute_dtype():
    tcfg = dataclasses.replace(get_config("minicpm-2b"), **SMALL)
    api = get_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(api, Env(torch.device("cpu"), torch.float32), params,
                      max_batch=3, max_len=16)
    assert eng.cache["k"].shape == (2, 3, 16, 2, 32)
    assert eng.cache["k"].dtype == torch.float32
    k_before = eng.cache["k"]
    eng.submit(np.arange(6), max_new_tokens=2)
    eng.run()
    assert eng.cache["k"] is k_before            # updated in place
    assert float(eng.cache["k"][:, 0, :6].abs().sum()) > 0


def test_launch_serve_end_to_end_on_cpu(capsys):
    res = serve_cli.main(["--device", "cpu", "--scale", "10m",
                          "--requests", "3", "--prompt-len", "16",
                          "--max-new", "4", "--max-batch", "2"])
    text = capsys.readouterr().out
    assert "ServingPlan:" in text and "tok/s" in text and "TTFT p50" in text
    assert res["requests"] == 3 and res["tokens"] == 12
    assert res["device"] == "cpu" and res["peak_mem_bytes"] is None


@pytest.mark.parametrize("device,mesh,graphed", [
    ("cuda", None, True),
    ("cuda:0", None, True),
    ("cpu", None, False),
    ("cuda", (1, 2), False),
    ("cuda", (2, 2), False),
    ("cpu", (1, 2), False),
])
def test_decode_graph_rule(device, mesh, graphed):
    """A CUDA graph exactly on a CUDA device without a mesh; the rule reads
    only the ``Env``, so no card is needed to check it."""
    env = Env(torch.device(device), torch.bfloat16,
              mesh=None if mesh is None else Mesh(mesh, ("data", "model")))
    assert decode_graphed(env) is graphed


def _tiny_engine(max_batch=2, max_len=24):
    tcfg = dataclasses.replace(get_config("minicpm-2b"), **SMALL)
    api = get_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    return ServeEngine(api, Env(torch.device("cpu"), torch.float32), params,
                       max_batch=max_batch, max_len=max_len)


def _prompts():
    return list(np.random.default_rng(5).integers(0, 512, (5, 10)))


def _serve_counting(engine, prompts):
    """Serve ``prompts`` with ``BUDGETS`` step by step: (tokens by request,
    engine steps)."""
    for prompt, budget in zip(prompts, BUDGETS):
        engine.submit(prompt, max_new_tokens=budget)
    done, steps = [], 0
    while engine.has_work():
        done.extend(engine.step())
        steps += 1
    return {r.rid: list(r.output) for r in done}, steps


def test_cpu_engine_decodes_eagerly_every_tick():
    eng = _tiny_engine()
    assert eng._graph is None
    out, steps = _serve_counting(eng, _prompts())
    assert [len(out[i]) for i in range(5)] == BUDGETS
    # every step with work decodes every slot once
    assert len(eng.timings["decode"]) == steps


class _Replay:
    """Stands in for the captured graph on the CPU: a replay runs the
    step it was made from."""

    def __init__(self, step):
        self.step = step
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.step()


def test_graph_branch_counts_and_gives_the_eager_tokens():
    """The tick's replay branch, with the graph stood in for: the same
    tokens as the eager engine, and one replay a tick."""
    want, _ = _serve_counting(_tiny_engine(), _prompts())
    eng = _tiny_engine()
    eng._graph = _Replay(eng._decode)
    got, steps = _serve_counting(eng, _prompts())
    assert got == want
    assert eng._graph.replays == steps == len(eng.timings["decode"])
