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


# ---------------------------------------------------------------------------
# Training under a mesh (tests/test_torch_train_shard.py)
# ---------------------------------------------------------------------------

#: tag -> ((data, model), microbatches, quant_block or 0): the runs of
#: ``tests/_torch_train_shard_ref.py`` beyond one step per mesh, on the
#: dense case
TRAIN_EXTRA = {"mb2": ((2, 2), 2, 0), "q16": ((2, 2), 1, 16),
               "q48": ((2, 2), 1, 48)}
TRAIN_OPT = dict(warmup=1, total_steps=10)
#: the parity tolerance of the sharded train step
TRAIN_TOL = 1e-5


def _train_batch(ref):
    batch = {k[len("batch/"):]: torch.from_numpy(ref[k])
             for k in ref.files if k.startswith("batch/")}
    for k in ("tokens", "labels"):
        batch[k] = batch[k].long()
    return batch


def _port_full(ref, prefix, cfg):
    """The reference's tree at ``prefix`` in the port's layout, whole, as
    a path -> numpy array dict."""
    from repro_torch.models.convert import _port_tree
    tree = _port_tree(_unflatten(ref, prefix), cfg, np.asarray,
                      lambda a: np.swapaxes(a, -1, -2))
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out[path] = node
    walk(tree, "")
    return out


def first_step_slack(mu_a, mu_b, opt):
    """Per element, what AdamW's first step may move a param by when two
    steps' clipped gradients differ by rounding: the step moves it by
    lr G / (|G| + eps) (plus the weight decay, equal in both), G = mu /
    (1 - b1), whose slope over [G_a, G_b] is at most eps / (m + eps)^2, m
    the smaller |G| (0 where the signs differ); times lr (the first step's
    lr is at most ``opt.lr``), capped at 2 lr.  A gradient that is zero but
    for rounding (a key bias's) gets up to 2 lr, any other a vanishing
    share of the base tolerance."""
    g_a = torch.as_tensor(mu_a, dtype=torch.float32) / (1 - opt.b1)
    g_b = torch.as_tensor(mu_b, dtype=torch.float32) / (1 - opt.b1)
    m = torch.where(g_a * g_b > 0, torch.minimum(g_a.abs(), g_b.abs()), 0.0)
    return opt.lr * torch.clamp(opt.eps * (g_a - g_b).abs()
                                / (m + opt.eps) ** 2, max=2.0)


def _param_excess(gap, slack, g_ref, tally):
    """The largest of ``gap`` less ``slack`` (what the base tolerance
    holds), and in ``tally`` the elements whose slack exceeds
    ``TRAIN_TOL``: their count, the largest reference |G| among them and
    the widest slack."""
    gap = torch.as_tensor(gap, dtype=torch.float32)
    wide = slack > TRAIN_TOL
    if wide.any():
        tally["n"] += int(wide.sum())
        tally["g"] = max(tally["g"], float(g_ref.abs()[wide].max()))
        tally["slack"] = max(tally["slack"], float(slack.max()))
    return float((gap - slack).max()) if gap.numel() else 0.0


def train_parity(rank, ref_dir, data, model, cases):
    """One fp32 train step of the port on the (data, model) mesh against
    the reference's sharded step from the same state and global batch:
    per case and run, the gap of the loss and the largest gap of every new
    param, ``mu`` and ``nu`` leaf (the rank's part of the reference's; a
    param's gap less ``first_step_slack``, the elements it widens past
    ``TRAIN_TOL`` tallied in ``params_slack``); with the int8 second
    moment, whether every code is
    within one of the reference's, the share that is not equal (a
    gradient a rounding apart lands on the other side of a half) and the
    largest relative gap of the block scales."""
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.optimizer import MeshLayout, adamw_init
    from repro_torch.train.tree import tree_leaves_with_path
    mesh = make_host_mesh(data, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    tag = f"{data}x{model}"
    out = {"coords": mesh.coords}
    for case in cases:
        cfg = case_config(case)
        api = get_model(cfg)
        ref = np.load(f"{ref_dir}/{case}.npz")
        layout = MeshLayout.of(cfg, env)
        runs = [(tag, 1, 0)]
        if case == "dense":
            runs += [(t, mb, qb) for t, (m, mb, qb) in TRAIN_EXTRA.items()
                     if m == (data, model)]
        for name, mb, qb in runs:
            params = params_from_jax(_unflatten(ref, "param"), cfg,
                                     device=CPU, dtype=torch.float32,
                                     mesh=mesh, batch_axes=env.batch_axes)
            opt = AdamWConfig(**TRAIN_OPT, quantize_nu=bool(qb),
                              quant_block=qb or 256)
            state = TrainState(params, adamw_init(params, opt, layout))
            step = make_train_step(api, env, opt, microbatches=mb)
            new, metrics = step(state, _train_batch(ref))
            res = {"loss": abs(float(metrics["loss"])
                               - float(ref[f"{name}/loss"]))}
            trees = {"params": new.params, "mu": new.opt.mu}
            if not qb:
                trees["nu"] = new.opt.nu
            ref_mu = _port_full(ref, f"{name}/mu", cfg)
            mus = dict(tree_leaves_with_path(new.opt.mu))
            tally = {"n": 0, "g": 0.0, "slack": 0.0}
            for part, tree in trees.items():
                full = _port_full(ref, f"{name}/{part}", cfg)
                worst = 0.0
                for path, t in tree_leaves_with_path(tree):
                    index = layout.rules[path].index
                    want = take(full[path], index)
                    if tuple(t.shape) != want.shape:
                        worst = float("inf")
                        continue
                    gap = np.abs(t.numpy() - want)
                    if part == "params":
                        mu_ref = torch.from_numpy(np.ascontiguousarray(
                            take(ref_mu[path], index)))
                        gap = _param_excess(
                            gap, first_step_slack(mus[path], mu_ref, opt),
                            mu_ref / (1 - opt.b1), tally)
                    worst = max(worst, float(np.max(gap, initial=0.0)))
                res[part] = worst
            res["params_slack"] = tally
            if qb:
                codes = _port_full(ref, f"{name}/nu", cfg)
                scales = _port_full(ref, f"{name}/nu_scale", cfg)
                equal, rel = True, 0.0
                n_codes = n_off = 0
                for (path, q), (_, s) in zip(
                        tree_leaves_with_path(new.opt.nu),
                        tree_leaves_with_path(new.opt.nu_scale)):
                    index = layout.rules[path].index
                    want = take(codes[path], index)
                    if tuple(q.shape) != want.shape:
                        equal = False
                        continue
                    off = np.abs(q.numpy().astype(np.int32)
                                 - want.astype(np.int32))
                    equal &= bool(off.max(initial=0) <= 1)
                    n_codes += off.size
                    n_off += int(np.count_nonzero(off))
                    axis = 0 if index and want.ndim == 2 and path.rsplit(
                        "/", 1)[-1] not in ("embed", "pos_embed",
                                            "conv_w") else want.ndim - 1
                    sidx = list(index)
                    sidx[axis] = None
                    ws = take(scales[path], tuple(sidx))
                    rel = max(rel, float(np.max(np.abs(s.numpy() - ws)
                                                / np.maximum(ws, 1e-30)))
                              if tuple(s.shape) == ws.shape
                              else float("inf"))
                res["codes_within_one"] = bool(equal)
                res["codes_off"] = n_off / max(n_codes, 1)
                res["scale_rel"] = rel
            if name == tag:
                res.update(_one_device_gaps(cfg, api, ref, new, layout,
                                            float(metrics["loss"])))
            out[f"{case}/{name}"] = res
    return out


def _one_device_gaps(cfg, api, ref, new, layout, loss):
    """The rank's new state against its part of the port's one-device
    step from the same state and batch."""
    from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves_with_path
    params = params_from_jax(_unflatten(ref, "param"), cfg, device=CPU,
                             dtype=torch.float32)
    opt = AdamWConfig(**TRAIN_OPT)
    one_env = env_for_mesh(None, "cpu", compute_dtype=torch.float32)
    one, metrics = make_train_step(api, one_env, opt)(
        TrainState(params, adamw_init(params, opt)), _train_batch(ref))
    res = {"one_loss": abs(float(metrics["loss"]) - loss)}
    one_mu = dict(tree_leaves_with_path(one.opt.mu))
    mus = dict(tree_leaves_with_path(new.opt.mu))
    tally = {"n": 0, "g": 0.0, "slack": 0.0}
    for part, mine, whole in (("params", new.params, one.params),
                              ("mu", new.opt.mu, one.opt.mu),
                              ("nu", new.opt.nu, one.opt.nu)):
        want = dict(tree_leaves_with_path(whole))
        worst = 0.0
        for path, t in tree_leaves_with_path(mine):
            index = layout.rules[path].index
            gap = (t - take(want[path], index)).abs()
            if part == "params":        # as train_parity's
                mu_one = take(one_mu[path], index)
                worst = max(worst, _param_excess(
                    gap, first_step_slack(mus[path], mu_one, opt),
                    mu_one / (1 - opt.b1), tally))
            else:
                worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        res[f"one_{part}"] = worst
    res["one_params_slack"] = tally
    return res


def knob_grads(rank, data, model, runs):
    """Gradients of one fp32 loss under each ``Env`` knob against the
    default's on the (data, model) mesh: per (case, knob), the largest gap
    of the loss and of any gradient element of the rank's shard."""
    from repro_torch.train import make_loss_fn
    from repro_torch.train.train_step import _working_copy, value_and_grad
    from repro_torch.train.tree import tree_leaves
    mesh = make_host_mesh(data, model, device_type="cpu")
    out = {}
    for case, knobs in runs:
        cfg = case_config(case)
        api = get_model(cfg)
        base = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
        params = api.init(torch.Generator().manual_seed(0), device=CPU,
                          env=base, fsdp=True)
        batch = _knob_batch(cfg)

        def grads(env):
            (loss, _), g = value_and_grad(make_loss_fn(api, env),
                                          _working_copy(params,
                                                        torch.float32),
                                          batch)
            return loss, tree_leaves(g)
        loss0, g0 = grads(base)
        for name, kw in knobs:
            loss, g = grads(dataclasses.replace(base, **kw))
            out[f"{case}/{name}"] = max(
                [abs(float(loss - loss0))]
                + [float((a - b).abs().max()) for a, b in zip(g, g0)])
    return out


def _knob_batch(cfg, B=4, S=16):
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    return batch


def forward_grads(rank, data, model, case):
    """One fp32 loss's gradients through ``forward`` on the (data, model)
    mesh, each the rank's part of the one-device gradient: the largest
    gap of the loss and of any gradient element."""
    from repro_torch.train import make_loss_fn
    from repro_torch.train.train_step import _working_copy, value_and_grad
    from repro_torch.train.tree import tree_leaves_with_path
    from repro_torch.train.optimizer import MeshLayout
    mesh = make_host_mesh(data, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    one = env_for_mesh(None, "cpu", compute_dtype=torch.float32)
    cfg = case_config(case)
    api = get_model(cfg)
    layout = MeshLayout.of(cfg, env)
    batch = _knob_batch(cfg)
    res = {}
    for name, e, kw in (("mesh", env, dict(env=env, fsdp=True)),
                        ("one", one, {})):
        params = api.init(torch.Generator().manual_seed(0), device=CPU, **kw)
        (loss, _), g = value_and_grad(make_loss_fn(api, e),
                                      _working_copy(params, torch.float32),
                                      batch)
        res[name] = (float(loss), dict(tree_leaves_with_path(g)))
    from repro_torch.distributed.sharding import reduce_grads
    reduce_grads(env, layout.rules, res["mesh"][1])
    gap = abs(res["mesh"][0] - res["one"][0])
    for path, g in res["mesh"][1].items():
        want = take(res["one"][1][path], layout.rules[path].index)
        gap = max(gap, float((g - want).abs().max()))
    return {"gap": gap, "leaves": len(res["mesh"][1])}


def quantize_split(rank, data, model, full, path, cfg_case, block):
    """The sharded int8 quantizer on the rank's part of the port-layout
    tensor ``full`` at ``path``: its codes and block scales."""
    from repro_torch.models.convert import reference_last_axis
    from repro_torch.train.optimizer import MeshLayout, _quantize
    mesh = make_host_mesh(data, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    cfg = case_config(cfg_case)
    layout = MeshLayout.of(cfg, env)
    x = torch.from_numpy(full)
    index = layout.rules[path].index
    local = take(x, index)
    axis = reference_last_axis(path, local)
    split = layout.split_axis(path, axis)
    q, scale = _quantize(local, block, axis, split)
    return {"q": q, "scale": scale, "index": index,
            "axis": axis % local.ndim, "split": split is not None}


def elastic_save(rank, data, model, ckpt_dir, state_file):
    """Save the rank's part of the one-device train state in
    ``state_file`` through the sharded save on the (data, model) mesh."""
    from repro_torch.train import AdamWConfig, Checkpointer, checkpoint_layout
    mesh = make_host_mesh(data, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    cfg = case_config("dense")
    api = get_model(cfg)
    opt = AdamWConfig(**TRAIN_OPT)
    whole = torch.load(state_file, weights_only=False)
    layout = checkpoint_layout(api, env, opt)
    from repro_torch.train.tree import tree_map_with_path
    mine = tree_map_with_path(lambda k, t: take(t, layout(k, t)[1]), whole)
    Checkpointer(ckpt_dir, async_save=False).save(3, mine, layout=layout)
    return True


def elastic_restore(rank, data, model, ckpt_dir, state_file):
    """Restore the checkpoint onto the (data, model) mesh; per leaf,
    whether the rank's restored part equals its part of the one-device
    state bit for bit."""
    from repro_torch.train import (AdamWConfig, Checkpointer,
                                   checkpoint_layout, init_train_state)
    from repro_torch.train.tree import tree_leaves_with_path
    mesh = make_host_mesh(data, model, device_type="cpu")
    env = env_for_mesh(mesh, "cpu", compute_dtype=torch.float32)
    cfg = case_config("dense")
    api = get_model(cfg)
    opt = AdamWConfig(**TRAIN_OPT)
    layout = checkpoint_layout(api, env, opt)
    template = init_train_state(api, torch.Generator().manual_seed(5), opt,
                                device=CPU, env=env)
    got, step, _ = Checkpointer(ckpt_dir).restore(
        template, sharding_fn=lambda k, leaf: layout(k, leaf)[1])
    whole = dict(tree_leaves_with_path(torch.load(state_file,
                                                  weights_only=False)))
    equal = all(torch.equal(t, take(whole[k], layout(k, t)[1]))
                for k, t in tree_leaves_with_path(got))
    return {"step": step, "equal": equal,
            "leaves": len(tree_leaves_with_path(got))}
