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
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..data import SyntheticTokens, TokenPipeline, plan_pipeline
from ..models import default_env, get_model
from ..train import (AdamWConfig, Checkpointer, init_train_state,
                     make_train_step)


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
                 log_every: int = 20) -> Dict[str, object]:
    """Train ``cfg`` from weights drawn on the device from ``seed`` (or
    from the latest checkpoint in ``ckpt_dir``) up to step ``steps``;
    returns the final ``state``, the ``train_step`` and last ``batch`` it
    ran, and the run's metrics: the loss of every step, step time p50
    (each step ends in a read of its loss), tokens/s and peak device
    memory."""
    env = default_env(device)
    api = get_model(cfg)
    dev = env.device
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{steps} steps @ batch {batch} x seq {seq} on {dev}")

    # -- data pipeline, scheduled by the paper's scheduler ----------------
    tokens_per_step = batch * seq
    if real_pipeline:
        docs_per_sec = tokens_per_step * 2.0   # ~2 steps/s target, ~1 doc/512 tok
        schedule = plan_pipeline(docs_per_sec)
        print("data pipeline plan:",
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
    state = init_train_state(api, gen, opt, device=dev)
    start_step = 0
    ckpt = None
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir)
        if ckpt.latest_step() is not None:
            state, start_step, _ = ckpt.restore(state)
            print(f"restored checkpoint at step {start_step}")

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
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"acc {float(metrics['accuracy']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"tok/s {tokens_seen / max(dt, 1e-9):.0f}")
        if ckpt and step > start_step and step % ckpt_every == 0:
            ckpt.save(step, state)
            print(f"checkpointed step {step}")
    wall = time.perf_counter() - t0
    if ckpt:
        ckpt.save(steps, state)
        ckpt.wait()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    return {
        "device": str(dev), "state": state, "train_step": step_fn,
        "batch": tb, "start_step": start_step, "steps": len(losses),
        "losses": losses, "step_ms": [s * 1e3 for s in step_s],
        "step_ms_p50": (float(np.median(step_s)) * 1e3 if step_s
                        else None),
        "wall_s": wall,
        "tokens_per_s": tokens_seen / wall if tokens_seen else None,
        "peak_mem_bytes": peak,
    }


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
    args = ap.parse_args(argv)

    res = run_training(
        scale_config(get_config(args.arch), args.scale), device=args.device,
        steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, real_pipeline=args.real_pipeline)
    if res["steps"]:
        print(f"{res['steps']} steps from step {res['start_step']}: loss "
              f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, step p50 "
              f"{res['step_ms_p50']:.1f} ms, {res['tokens_per_s']:.0f} tok/s "
              f"on {res['device']}")
    print("done.")
    return res


if __name__ == "__main__":
    main()
