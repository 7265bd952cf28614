"""Training launcher: data pipeline (scheduled by MBA+SAM) -> train loop with
checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --scale 100m --steps 300 --batch 8 --seq 256 --ckpt-dir CKPT  # GPU
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --scale 10m --steps 6

Flags as the reference's ``python -m repro.launch.train``, plus
``--device`` (default ``cuda``; there is no silent CPU fallback).  bf16
compute over fp32 master params and AdamW state, each layer recomputed in
the backward (``Env.remat``).  A run with ``--ckpt-dir`` restores the
latest checkpoint there and continues from its step; relaunching with the
same directory is the restart.

``--mesh D,M``: train sharded over ``D x M`` rank processes on a (data,
model) mesh (``distributed/spawn.py``; NCCL with one card a rank, or gloo
with ``--device cpu``): FSDP over data, tensor parallelism over model,
every rank holding its shard of the fp32 master and AdamW state and
running its block of each global batch.  A checkpoint is the one-device
run's files, so a run may restart on another mesh (or none).

    PYTHONPATH=src python -m repro_torch.launch.train --mesh 2,2 --device cpu \
        --scale 10m --steps 4
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config
from ..configs.base import REDUCED_PATTERN, ModelConfig
from ..data import SyntheticTokens, TokenPipeline, plan_pipeline
from ..distributed.collectives import recording
from ..distributed.spawn import spawn
from ..models import default_env, get_model
from ..train import (AdamWConfig, Checkpointer, checkpoint_layout,
                     init_train_state, make_train_step)
from .mesh import env_for_mesh, make_host_mesh


def scale_config(cfg: ModelConfig, scale: str) -> ModelConfig:
    """Derive a runnable-size config of the same family."""
    if scale == "full":
        return cfg
    presets = {
        "100m": dict(num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
                     head_dim=64, d_ff=2048, vocab_size=32768),
        "10m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                    head_dim=64, d_ff=1024, vocab_size=8192),
    }
    kw = dict(presets[scale])
    if cfg.family in ("ssm", "hybrid"):
        kw.pop("num_heads"), kw.pop("num_kv_heads"), kw.pop("head_dim")
        if cfg.family == "ssm":
            kw["d_ff"] = 0
    if cfg.family == "moe":
        kw.update(num_experts=min(cfg.num_experts, 8),
                  experts_per_token=min(cfg.experts_per_token, 2),
                  d_ff=512)
    if cfg.family == "hybrid_moe":
        kw.update(layer_pattern=REDUCED_PATTERN,
                  num_layers=len(REDUCED_PATTERN), num_experts=8,
                  experts_per_token=2, d_ff=512, shared_d_ff=1024,
                  ssm_heads=kw["d_model"] * 2 // cfg.ssm_head_dim,
                  ssm_groups=2)
    if cfg.family == "audio":
        kw.update(encoder_layers=4, encoder_seq=64)
    if cfg.family == "vlm":
        kw.update(num_patches=16)
    return dataclasses.replace(cfg, **kw, name=cfg.name + f"-{scale}")


def run_training(cfg: ModelConfig, *, device: Optional[str] = None,
                 steps: int = 300, batch: int = 8, seq: int = 256,
                 lr: float = 3e-4, microbatches: int = 1,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
                 real_pipeline: bool = False, seed: int = 0,
                 log_every: int = 20,
                 mesh: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, object]:
    """Train ``cfg`` from weights drawn on the device from ``seed`` (or
    from the latest checkpoint in ``ckpt_dir``) up to step ``steps``;
    returns the final ``state``, the ``train_step`` and last ``batch`` it
    ran, the checkpoint ``layout`` of a sharded state (None without a
    mesh), and the run's metrics: the loss of every step, step time p50
    (each step ends in a read of its loss), tokens/s and peak device
    memory.

    ``mesh=(data, model)``: outside a process group, start ``data x
    model`` ranks (:func:`train_rank`) and return rank 0's metrics (no
    state, step or batch: they live in the ranks) with every rank's
    ``peak_mem_bytes_by_rank``; inside one (a rank), train this rank's
    shard on the mesh."""
    if mesh is not None and not dist.is_initialized():
        dev_type = torch.device("cuda" if device is None else device).type
        ranks = mesh[0] * mesh[1]
        opts = dict(steps=steps, batch=batch, seq=seq, lr=lr,
                    microbatches=microbatches, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every, real_pipeline=real_pipeline,
                    seed=seed, log_every=log_every)
        out = spawn(train_rank, ranks, args=(cfg, dev_type, tuple(mesh), opts),
                    device=dev_type, timeout=24 * 3600.0,
                    threads=(None if dev_type == "cuda"
                             else max(1, (os.cpu_count() or 1) // ranks)))
        res = dict(out[0])
        res["peak_mem_bytes_by_rank"] = [r["peak_mem_bytes"] for r in out]
        return res
    if mesh is None:
        env = default_env(device)
    else:
        dev_type = torch.device("cuda" if device is None else device).type
        where = (torch.device("cuda", torch.cuda.current_device())
                 if dev_type == "cuda" else "cpu")
        env = env_for_mesh(make_host_mesh(*mesh, device_type=dev_type),
                           where)
    api = get_model(cfg)
    dev = env.device
    lead = env.mesh is None or env.mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
        f"{steps} steps @ batch {batch} x seq {seq} on {dev}"
        + (f", mesh {env.mesh.shape}" if env.mesh is not None else ""))

    # -- data pipeline, scheduled by the paper's scheduler ----------------
    tokens_per_step = batch * seq
    if real_pipeline:
        docs_per_sec = tokens_per_step * 2.0   # ~2 steps/s target, ~1 doc/512 tok
        schedule = plan_pipeline(docs_per_sec)
        say("data pipeline plan:",
            {t.task: t.threads for t in schedule.allocation.tasks.values()},
            f"on {schedule.acquired_slots} host slots")
        batches = TokenPipeline(seq, batch, schedule).batches(steps)

        def next_batch():
            return next(batches)
    else:
        src = SyntheticTokens(seq, batch, cfg.vocab_size)

        def next_batch():
            return src.next()

    # -- train state (restore if a checkpoint exists: fault tolerance) ----
    opt = AdamWConfig(lr=lr, warmup=max(10, steps // 20), total_steps=steps,
                      schedule=cfg.lr_schedule)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(api, gen, opt, device=dev,
                             env=env if env.mesh is not None else None)
    layout = checkpoint_layout(api, env, opt)
    start_step = 0
    ckpt = None
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, async_save=layout is None)
        if ckpt.latest_step() is not None:
            state, start_step, _ = ckpt.restore(
                state, sharding_fn=(lambda k, leaf: layout(k, leaf)[1])
                if layout else None)
            say(f"restored checkpoint at step {start_step}")

    step_fn = make_train_step(api, env, opt, microbatches=microbatches)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    losses: List[float] = []
    step_s: List[float] = []
    tokens_seen = 0
    t0 = time.perf_counter()
    tb = None
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        tb = {k: torch.as_tensor(v, dtype=torch.long).to(dev)
              for k, v in next_batch().items()}
        if cfg.family == "vlm":
            tb["patch_embeds"] = torch.zeros(
                (batch, cfg.num_patches, cfg.d_model),
                dtype=env.compute_dtype, device=dev)
        if cfg.family == "audio":
            tb["frames"] = torch.zeros(
                (batch, cfg.encoder_seq, cfg.d_model),
                dtype=env.compute_dtype, device=dev)
        state, metrics = step_fn(state, tb)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        tokens_seen += tokens_per_step
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            say(f"step {step:5d}  loss {losses[-1]:.4f}  "
                f"acc {float(metrics['accuracy']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"tok/s {tokens_seen / max(dt, 1e-9):.0f}")
        if ckpt and step > start_step and step % ckpt_every == 0:
            ckpt.save(step, state, layout=layout)
            say(f"checkpointed step {step}")
    wall = time.perf_counter() - t0
    if ckpt:
        ckpt.save(steps, state, layout=layout)
        ckpt.wait()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return {
        "device": str(dev), "state": state, "train_step": step_fn,
        "batch": tb, "layout": layout,
        "start_step": start_step, "steps": len(losses),
        "losses": losses, "step_ms": [s * 1e3 for s in step_s],
        "step_ms_p50": (float(np.median(step_s)) * 1e3 if step_s
                        else None),
        "wall_s": wall,
        "tokens_per_s": tokens_seen / wall if tokens_seen else None,
        "peak_mem_bytes": peak,
    }


def train_rank(rank: int, cfg: ModelConfig, device_type: str,
               mesh: Tuple[int, int], opts: Dict[str, object]
               ) -> Dict[str, object]:
    """One rank of ``run_training(..., mesh=mesh)``: its metrics, with
    ``rank`` and the collectives one more step issues (``collectives``,
    recorded after the run, on its last batch)."""
    res = run_training(cfg, device=device_type, mesh=mesh, **opts)
    state, step_fn, batch = (res.pop("state"), res.pop("train_step"),
                             res.pop("batch"))
    res.pop("layout")
    steps = {}
    if batch is not None:
        with recording() as steps["step"]:
            step_fn(state, batch)
    res.update(rank=rank, collectives={k: v.as_dict()
                                       for k, v in steps.items()})
    return res


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--scale", default="100m", choices=["10m", "100m", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--real-pipeline", action="store_true",
                    help="use the scheduled host data pipeline instead of "
                         "synthetic tokens")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train over D x M ranks on a (data, model) mesh")
    args = ap.parse_args(argv)

    mesh = (tuple(int(n) for n in args.mesh.split(","))
            if args.mesh else None)
    res = run_training(
        scale_config(get_config(args.arch), args.scale), device=args.device,
        steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, real_pipeline=args.real_pipeline,
        mesh=mesh)
    if res["steps"]:
        print(f"{res['steps']} steps from step {res['start_step']}: loss "
              f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, step p50 "
              f"{res['step_ms_p50']:.1f} ms, {res['tokens_per_s']:.0f} tok/s "
              f"on {res['device']}")
    print("done.")
    return res


if __name__ == "__main__":
    main()
