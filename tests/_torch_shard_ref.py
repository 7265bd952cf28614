"""The reference's sharded serving program, run for the port's multi-rank
tests (``tests/test_torch_tp.py``): ``python tests/_torch_shard_ref.py OUT``.

On 4 forced host devices, for each family's reduced config (and a GQA
variant whose 2 KV heads do not divide a tp of 4) and each mesh of
``MESHES``, the reference's ``prefill`` and two ``decode_step`` calls run
jitted under ``env_for_mesh`` in fp32.  Written to ``OUT``: ``{case}.npz``
with the reference's params (``param/...``, its own layout), the inputs,
the logits and caches, and for MoE every rank's routing
(``route/{call}/{data}/{model}/{layer}/ids|valid``, recorded from inside
the ``shard_map`` body by a ``jax.debug.callback`` around
``_dispatch_local``).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro.models.moe as jax_moe  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.launch.mesh import env_for_mesh  # noqa: E402
from repro.models import get_model  # noqa: E402

#: case name -> (arch, overrides of its reduced config)
CASES = {"dense": ("minicpm-2b", {}),
         "gqa": ("qwen2-72b", {"num_kv_heads": 2}),
         "moe": ("moonshot-v1-16b-a3b", {}),
         "vlm": ("phi-3-vision-4.2b", {}),
         "ssm": ("mamba2-370m", {}),
         "hybrid": ("zamba2-1.2b", {}),
         "audio": ("whisper-large-v3", {})}
#: (data, model)
MESHES = ((1, 2), (1, 4), (2, 2))
B, S, MAX_LEN, STEPS = 2, 8, 12, 2

_ROUTES = []
_dispatch = jax_moe._dispatch_local


def _recorded_dispatch(x_flat, ids, capacity, num_experts, k):
    buf, slot, valid = _dispatch(x_flat, ids, capacity, num_experts, k)
    jax.debug.callback(
        lambda d, m, i, v: _ROUTES.append((int(d), int(m), np.asarray(i),
                                           np.asarray(v))),
        jax.lax.axis_index("data"), jax.lax.axis_index("model"), ids, valid)
    return buf, slot, valid


jax_moe._dispatch_local = _recorded_dispatch


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)
    return out


def inputs(cfg, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.num_patches,
                                                 cfg.d_model))
    steps = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(STEPS)]
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v
            for k, v in batch.items()}, steps


def routes(call):
    jax.effects_barrier()
    out, seen = {}, {}
    for d, m, ids, valid in _ROUTES:
        layer = seen.get((d, m), 0)
        seen[(d, m)] = layer + 1
        out[f"route/{call}/{d}/{m}/{layer}/ids"] = ids
        out[f"route/{call}/{d}/{m}/{layer}/valid"] = valid
    _ROUTES.clear()
    return out


def run(case, out_dir):
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    api = get_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch, steps = inputs(cfg, rng)
    arrays = {**flat(params, "param"),
              **{f"batch/{k}": v for k, v in batch.items()},
              **{f"step/{i}": s for i, s in enumerate(steps)}}
    for data, model in MESHES:
        mesh = Mesh(np.array(jax.devices()[: data * model]).reshape(
            data, model), ("data", "model"))
        env = env_for_mesh(mesh, compute_dtype=jnp.float32)
        tag = f"{data}x{model}"
        with mesh:
            prefill = jax.jit(lambda p, b: api.prefill(env, p, b, MAX_LEN))
            decode = jax.jit(lambda p, c, b: api.decode_step(env, p, c, b))
            logits, cache = prefill(params, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
            arrays.update({f"{tag}/prefill/logits": np.asarray(logits),
                           **flat(cache, f"{tag}/prefill/cache"),
                           **routes(f"{tag}/prefill")})
            pos = np.array([S, S - 3], np.int32)
            for i, step in enumerate(steps):
                logits, cache = decode(params, cache, {
                    "tokens": jnp.asarray(step), "pos": jnp.asarray(pos)})
                arrays.update({f"{tag}/decode{i}/logits": np.asarray(logits),
                               **routes(f"{tag}/decode{i}")})
                pos = pos + 1
            arrays.update(flat(cache, f"{tag}/decode/cache"))
    np.savez(os.path.join(out_dir, f"{case}.npz"), **arrays)


if __name__ == "__main__":
    out_dir = sys.argv[1]
    for case in (sys.argv[2:] or CASES):
        run(case, out_dir)
    print("SHARD_REF_OK")
