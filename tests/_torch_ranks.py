"""Rank bodies of the port's multi-rank tests.

Each function here runs inside a rank process started by
``repro_torch.distributed.spawn`` over gloo on the CPU (one thread a rank)
and returns plain numbers and CPU tensors for the test to assert on.  It
imports neither JAX nor the reference: the reference's outputs come from
the ``.npz`` files that ``tests/_torch_shard_ref.py`` and the tests' own
subprocesses write.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (batch_spec, local_cache_index,
                                              local_index, local_shard, take)
from repro_torch.launch.mesh import env_for_mesh, make_host_mesh
from repro_torch.models import common, get_model, moe, params_from_jax
from repro_torch.serve import ServeEngine

CPU = torch.device("cpu")
#: the cases of ``tests/_torch_shard_ref.py``: arch and config overrides
CASES = {"dense": ("minicpm-2b", {}),
         "gqa": ("qwen2-72b", {"num_kv_heads": 2}),
         "moe": ("moonshot-v1-16b-a3b", {}),
         "vlm": ("phi-3-vision-4.2b", {}),
         "ssm": ("mamba2-370m", {}),
         "hybrid": ("zamba2-1.2b", {}),
         "audio": ("whisper-large-v3", {})}
S = 8


def case_config(case):
    arch, overrides = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), **overrides)


def _unflatten(arrays, prefix):
    tree = {}
    for key in arrays.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arrays[key]
    return tree


@contextlib.contextmanager
def recorded_routes():
    """Every ``moe._dispatch_local`` call's assignments (ids) and which of
    them found room (valid), in call order."""
    calls = []
    inner = moe._dispatch_local

    def wrapper(x_flat, ids, capacity, num_experts, k):
        out = inner(x_flat, ids, capacity, num_experts, k)
        calls.append((ids.clone(), out[2].clone()))
        return out
    moe._dispatch_local = wrapper
    try:
        yield calls
    finally:
        moe._dispatch_local = inner


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32)), initial=0.0))


def _routes_equal(calls, ref, tag, coords):
    d, m = coords["data"], coords["model"]
    want = []
    layer = 0
    while f"route/{tag}/{d}/{m}/{layer}/ids" in ref.files:
        want.append((ref[f"route/{tag}/{d}/{m}/{layer}/ids"],
                     ref[f"route/{tag}/{d}/{m}/{layer}/valid"]))
        layer += 1
    return len(want) == len(calls) and all(
        np.array_equal(i.numpy(), wi) and np.array_equal(v.numpy(), wv)
        for (i, v), (wi, wv) in zip(calls, want))


def parity(rank, ref_dir, data, model, cases):
    """The port on the (data, model) mesh against the reference's sharded
    run: per case, the largest gap of the prefill and decode logits and of
    every cache entry (this rank's part of the reference's), whether every
    MoE routing decision and drop is equal, and the rank's init shard
    against the one-device init's same part."""
    mesh = make_host_mesh(data, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    tag = f"{data}x{model}"
    out = {"coords": mesh.coords}
    for case in cases:
        cfg = case_config(case)
        api = get_model(cfg)
        ref = np.load(f"{ref_dir}/{case}.npz")
        params = params_from_jax(_unflatten(ref, "param"), cfg, device=CPU,
                                 dtype=torch.float32, mesh=mesh)
        batch = {k[len("batch/"):]: torch.from_numpy(ref[k])
                 for k in ref.files if k.startswith("batch/")}
        batch["tokens"] = batch["tokens"].long()
        res = {}
        with recorded_routes() as calls:
            logits, cache = api.prefill(env, params, batch, 12)
        res["prefill_logits"] = _err(logits, _local(
            env, ref[f"{tag}/prefill/logits"]))
        res["routes_equal"] = _routes_equal(calls, ref, f"{tag}/prefill",
                                            mesh.coords)
        res.update(_cache_errs(cfg, env, cache, ref, f"{tag}/prefill/cache",
                               "prefill"))
        pos = torch.tensor([S, S - 3])
        i = 0
        while f"step/{i}" in ref.files:
            step = {"tokens": torch.from_numpy(ref[f"step/{i}"]).long(),
                    "pos": pos}
            with recorded_routes() as calls:
                logits, cache = api.decode_step(env, params, cache, step)
            res[f"decode{i}_logits"] = _err(logits, _local(
                env, ref[f"{tag}/decode{i}/logits"]))
            res["routes_equal"] &= _routes_equal(calls, ref,
                                                 f"{tag}/decode{i}",
                                                 mesh.coords)
            pos = pos + 1
            i += 1
        res.update(_cache_errs(cfg, env, cache, ref, f"{tag}/decode/cache",
                               "decode"))
        res["init_equal"] = _init_slices_equal(cfg, env)
        out[case] = res
    return out


def _local(env, full):
    """This rank's part of a global (B, ...) output of the reference."""
    return local_shard(full, batch_spec(env, "logits", full.shape), env.mesh)


def _cache_errs(cfg, env, cache, ref, prefix, label):
    errs = {}
    for name, t in cache.items():
        full = ref[f"{prefix}/{name}"]
        if name.startswith("shared_"):
            full = full[: t.shape[0]]
        want = take(full, local_cache_index(cfg, env, name, full.shape))
        errs[f"{label}_cache_{name}"] = (_err(t, want)
                                         if tuple(t.shape) == want.shape
                                         else float("inf"))
    return errs


def _init_slices_equal(cfg, env):
    """With tiles of 16 (so that shards cut across tiles), the rank's init
    equals its part of the one-device init, leaf by leaf."""
    api = get_model(cfg)
    tile = common.TILE
    common.TILE = 16
    try:
        mine = api.init(torch.Generator().manual_seed(3), device=CPU,
                        env=env)
        whole = api.init(torch.Generator().manual_seed(3), device=CPU)
    finally:
        common.TILE = tile
    ok = True

    def walk(a, b, path):
        nonlocal ok
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}" if path else k)
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            want = take(b, local_index(cfg, env.mesh, path, b.shape))
            ok &= tuple(a.shape) == tuple(want.shape) and torch.equal(a, want)
    walk(mine, whole, "")
    return ok


def serve_tokens(rank, model):
    """Greedy tokens of five ragged requests on the dense reduced config at
    tp ``model`` and on the one-device engine in the same process."""
    cfg = case_config("dense")
    api = get_model(cfg)
    mesh = make_host_mesh(1, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    one = env_for_mesh(None, "cpu", compute_dtype=torch.float32)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (5, 10))
    tokens = {}
    for name, e in (("sharded", env), ("one", one)):
        params = api.init(torch.Generator().manual_seed(0), device=CPU,
                          env=e if e.mesh is not None else None)
        eng = ServeEngine(api, e, params, max_batch=3, max_len=24)
        for prompt, budget in zip(prompts, [3, 7, 2, 6, 4]):
            eng.submit(prompt, max_new_tokens=budget)
        tokens[name] = {r.rid: list(r.output) for r in eng.run()}
    return tokens


def decode_collectives(rank, model):
    """The collectives one decode step of two sequences issues on the dense
    reduced config at tp ``model``."""
    cfg = case_config("dense")
    api = get_model(cfg)
    env = env_for_mesh(make_host_mesh(1, model, device_type="cpu"), "cpu",
                       compute_dtype=torch.float32)
    params = api.init(torch.Generator().manual_seed(0), device=CPU, env=env)
    _, cache = api.prefill(env, params, {"tokens": torch.zeros(
        (2, 10), dtype=torch.long)}, 16)
    with collectives.recording() as stats:
        api.decode_step(env, params, cache, {
            "tokens": torch.zeros((2, 1), dtype=torch.long),
            "pos": torch.tensor([10, 10])})
    return stats.as_dict()


def three_collectives(rank):
    """The three ops of the reference's HLO-parser test issued through the
    wrappers on a (2, 2) mesh: an all-gather into bf16 (16, 1024) over all
    four ranks, an all-reduce of f32 (256,) over pairs, and an all-to-all
    of 256 bytes over pairs."""
    mesh = make_host_mesh(2, 2, device_type="cpu")
    with collectives.recording() as stats:
        g = collectives.all_gather(
            torch.full((4, 1024), float(rank), dtype=torch.bfloat16),
            mesh.group(("data", "model")))
        r = collectives.all_reduce(torch.ones(256), mesh.group("model"))
        # block j of rank r holds r + 10 j
        a = collectives.all_to_all(
            float(rank) + 10.0 * torch.arange(2.0)[:, None, None]
            .expand(2, 4, 8), mesh.group("data"))
    return {"stats": stats.as_dict(), "gather": g[::4, 0].float(),
            "reduce": r[0].item(), "a2a": a[:, 0, 0]}


def pipeline(rank, ws, x, n_mb):
    """``gpipe`` over a pipe axis of every rank: stage ``rank`` holds only
    its layers; returns the output and the collectives issued."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import gpipe, split_stages
    world = torch.distributed.get_world_size()
    mesh = Mesh.attach((world,), ("pipe",), "cpu")
    mine = split_stages(torch.from_numpy(ws), world)[rank:rank + 1]

    def layer_fn(stage_params, c):
        for w in stage_params:
            c = torch.tanh(c @ w)
        return c
    f = gpipe(layer_fn, mesh, pipe_axis="pipe", n_microbatches=n_mb)
    with collectives.recording() as stats:
        y = f(mine, torch.from_numpy(x))
    return {"y": y, "stats": stats.as_dict()}


def compressed_reduce(rank, grads, block, steps):
    """``ErrorFeedbackCompressor.reduce`` over every rank, ``steps`` times
    with the residual carried; rank r's gradient is ``grads[r]``."""
    from repro_torch.distributed.compression import ErrorFeedbackCompressor
    from repro_torch.distributed.mesh import Mesh
    world = torch.distributed.get_world_size()
    mesh = Mesh.attach((world,), ("dp",), "cpu")
    comp = ErrorFeedbackCompressor(block=block)
    g = {"w": torch.from_numpy(grads[rank])}
    state = comp.init_state(g)
    outs = []
    for _ in range(steps):
        out, state = comp.reduce(g, state, mesh.group("dp"))
        outs.append(out["w"])
    return {"out": outs, "residual": state["w"]}
