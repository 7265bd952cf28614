"""The reference's sharded training step, run for the port's multi-rank
training tests (``tests/test_torch_train_shard.py``):
``python tests/_torch_train_shard_ref.py OUT [case...]``.

On 4 forced host devices, for each family's reduced config (and the GQA
variant whose 2 KV heads do not divide a tp of 4), the reference's
``make_train_step`` runs one fp32 step jitted under ``env_for_mesh`` on
each mesh of ``MESHES`` (``(data, model)``), from the same state and the
same global batch.  ``EXTRA`` adds the step with ``microbatches=2`` and
with the int8 second moment (``quantize_nu``, blocks of 16 and 48) on
(2, 2).  Written to ``OUT``: ``{case}.npz`` with the initial params
(``param/...``, the reference's layout), the batch, and per run
``{tag}/loss`` and the new state's ``{tag}/params/...``, ``{tag}/mu/...``,
``{tag}/nu/...`` (and ``{tag}/nu_scale/...``).
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

from repro.configs import get_config  # noqa: E402
from repro.launch.mesh import env_for_mesh  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.train import AdamWConfig, init_train_state, make_train_step  # noqa: E402

CASES = {"dense": ("minicpm-2b", {}),
         "gqa": ("qwen2-72b", {"num_kv_heads": 2}),
         "moe": ("moonshot-v1-16b-a3b", {}),
         "vlm": ("phi-3-vision-4.2b", {}),
         "ssm": ("mamba2-370m", {}),
         "hybrid": ("zamba2-1.2b", {}),
         "audio": ("whisper-large-v3", {})}
#: (data, model)
MESHES = ((2, 2), (1, 4), (4, 1))
#: tag -> (mesh, microbatches, quant_block or 0), on the dense case
EXTRA = {"mb2": ((2, 2), 2, 0), "q16": ((2, 2), 1, 16),
         "q48": ((2, 2), 1, 48)}
B, S = 4, 8
OPT = dict(warmup=1, total_steps=10)


def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)
    return out


def batch_of(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(B, cfg.num_patches,
                                                 cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64
            else v.astype(np.int32) for k, v in batch.items()}


def step_on(api, cfg, mesh_shape, batch, microbatches=1, quant_block=0):
    data, model = mesh_shape
    mesh = Mesh(np.array(jax.devices()[: data * model]).reshape(
        data, model), ("data", "model"))
    env = env_for_mesh(mesh, compute_dtype=jnp.float32)
    opt = AdamWConfig(**OPT, quantize_nu=bool(quant_block),
                      quant_block=quant_block or 256)
    state = init_train_state(api, jax.random.PRNGKey(0), opt)
    with mesh:
        # lint: ok JAX110 - one compile per mesh and run is the test's input
        step = jax.jit(make_train_step(api, env, opt,
                                       microbatches=microbatches))
        new, metrics = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    out = {"loss": np.asarray(metrics["loss"]),
           **flat(new.params, "params"), **flat(new.opt.mu, "mu"),
           **flat(new.opt.nu, "nu")}
    if new.opt.nu_scale is not None:
        out.update(flat(new.opt.nu_scale, "nu_scale"))
    return out


def run(case, out_dir):
    arch, overrides = CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    api = get_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    batch = batch_of(cfg)
    arrays = {**flat(params, "param"),
              **{f"batch/{k}": v for k, v in batch.items()}}
    runs = {f"{d}x{m}": ((d, m), 1, 0) for d, m in MESHES}
    if case == "dense":
        runs.update(EXTRA)
    for tag, (mesh_shape, mb, qb) in runs.items():
        for k, v in step_on(api, cfg, mesh_shape, batch, mb, qb).items():
            arrays[f"{tag}/{k}"] = v
    np.savez(os.path.join(out_dir, f"{case}.npz"), **arrays)


if __name__ == "__main__":
    out_dir = sys.argv[1]
    for case in (sys.argv[2:] or CASES):
        run(case, out_dir)
    print("TRAIN_SHARD_REF_OK")
