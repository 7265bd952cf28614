"""Serving launcher: MBA+SAM plans the GPU split, the continuous-batching
engine serves batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \\
        --requests 12 --rate 4 --max-new 16            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --device cpu                                   # or zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 4   # 4 cards
    PYTHONPATH=src python -m repro_torch.launch.serve --tp 2 --device cpu

Flags as the reference's ``python -m repro.launch.serve``, plus
``--device`` (default ``cuda``; there is no silent CPU fallback) and
``--tp R``: serve sharded over ``R`` rank processes (``distributed/
spawn.py``; NCCL with one card a rank, or gloo with ``--device cpu``), the
weights and caches split by the sharding rules
(``distributed/sharding.py``), each rank drawing only its shard.  Rank 0
reports the metrics, plus ``ranks`` and the collectives it issued.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..distributed.collectives import recording
from ..distributed.spawn import spawn
from ..models import Env, default_env, get_model
from ..models.api import ModelApi
from ..serve import ServeEngine, plan_serving
from .mesh import env_for_mesh, make_host_mesh
from .train import scale_config


def run_serving(cfg: ModelConfig, *, device: Optional[str] = None,
                requests: int = 12, prompt_len: int = 32, max_new: int = 16,
                max_batch: int = 4, seed: int = 0,
                tp: Optional[int] = None) -> Dict[str, object]:
    """Serve ``requests`` random prompts on ``cfg`` in bf16 with random
    weights drawn on the device from ``seed``; returns the finished requests
    (``done``), the engine and the run's metrics.  With ``tp``, serve over
    ``tp`` rank processes on a (1, tp) mesh and return rank 0's metrics
    and finished requests, with ``ranks``, its ``collectives`` and every
    rank's ``peak_mem_bytes_by_rank`` (no engine: it lives in the rank)."""
    if tp is not None:
        dev = torch.device("cuda" if device is None else device)
        out = spawn(serve_rank, tp, args=(tp, cfg, str(dev.type), dict(
            requests=requests, prompt_len=prompt_len, max_new=max_new,
            max_batch=max_batch, seed=seed)), device=dev.type,
            threads=(None if dev.type == "cuda"
                     else max(1, (os.cpu_count() or 1) // tp)))
        res = dict(out[0])
        res["peak_mem_bytes_by_rank"] = [r["peak_mem_bytes"] for r in out]
        return res
    env = default_env(device)
    api = get_model(cfg)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    params = api.init(gen, device=env.device, dtype=env.compute_dtype)
    return serve_workload(env, api, params, requests=requests,
                          prompt_len=prompt_len, max_new=max_new,
                          max_batch=max_batch, seed=seed)


def sharded_model(rank: int, tp: int, cfg: ModelConfig, device_type: str,
                  seed: int = 0, dtype: torch.dtype = torch.bfloat16
                  ) -> Tuple[Env, ModelApi, Dict]:
    """Inside rank ``rank`` of a world of ``tp``: the (1, tp) mesh's env
    (``dtype``, card ``rank`` or the CPU), the model's API and this rank's
    shard of the weights drawn from ``seed`` (equal to its part of the
    one-device draw)."""
    mesh = make_host_mesh(1, tp, device_type=device_type)
    env = env_for_mesh(mesh, torch.device(device_type, rank)
                       if device_type == "cuda" else "cpu",
                       compute_dtype=dtype)
    api = get_model(cfg)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    params = api.init(gen, device=env.device, dtype=env.compute_dtype,
                      env=env)
    return env, api, params


def serve_rank(rank: int, tp: int, cfg: ModelConfig, device_type: str,
               opts: Dict[str, int]) -> Dict[str, object]:
    """One rank of ``run_serving(..., tp=tp)``: its metrics, ``ranks`` and
    the collectives it issued over the run (``collectives``) and in one
    more prefill and one more decode step (``step_collectives``)."""
    env, api, params = sharded_model(rank, tp, cfg, device_type,
                                     opts["seed"])
    with recording() as stats:
        res = serve_workload(env, api, params, **opts)
    eng = res.pop("engine")
    batch = eng.prefill_batch(res["done"][0].prompt)
    steps = {}
    with recording() as steps["prefill"]:
        api.prefill(env, params, batch, max_len=eng.max_len)
    with recording() as steps["decode"]:
        api.decode_step(env, params, eng.cache, {
            "tokens": batch["tokens"][:, :1].expand(eng.max_batch, 1),
            "pos": torch.full((eng.max_batch,), res["done"][0].prompt.size,
                              device=env.device)})
    res.update(ranks=tp, rank=rank, collectives=stats.as_dict(),
               step_collectives={k: v.as_dict() for k, v in steps.items()})
    return res


def serve_workload(env: Env, api: ModelApi, params: Dict, *,
                   requests: int, prompt_len: int, max_new: int,
                   max_batch: int, seed: int) -> Dict[str, object]:
    """The serving run of :func:`run_serving` on a model already placed."""
    cfg = api.cfg
    eng = ServeEngine(api, env, params, max_batch=max_batch,
                      max_len=prompt_len + max_new + 8)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
        torch.cuda.reset_peak_memory_stats(env.device)

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for _ in range(requests):
        eng.submit(rng.integers(0, cfg.vocab_size, prompt_len),
                   max_new_tokens=max_new)
    done = eng.run()
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output) for r in done)
    ttfts = [r.first_token_at - r.submitted for r in done]
    e2es = [r.finished_at - r.submitted for r in done]
    peak = (torch.cuda.max_memory_allocated(env.device)
            if env.device.type == "cuda" else None)
    return {
        "device": str(env.device),
        "done": done,
        "engine": eng,
        "requests": len(done),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
        "ttft_p99_ms": float(np.percentile(ttfts, 99)) * 1e3,
        "e2e_p50_ms": float(np.percentile(e2es, 50)) * 1e3,
        "peak_mem_bytes": peak,
        "prefills": len(eng.timings["prefill"]),
        "prefill_ms_first": eng.timings["prefill"][0] * 1e3,
        "prefill_ms_p50": float(np.median(eng.timings["prefill"])) * 1e3,
        "decode_steps": len(eng.timings["decode"]),
        "decode_ms_first": eng.timings["decode"][0] * 1e3,
        "decode_ms_p50": float(np.median(eng.timings["decode"])) * 1e3,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--scale", default="10m", choices=["10m", "100m", "full"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=4.0, help="req/s offered")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=None,
                    help="serve sharded over this many rank processes")
    args = ap.parse_args(argv)

    # 1. the paper's technique: plan the GPU allocation for the FULL arch
    full_cfg = get_config(args.arch)
    sp = plan_serving(full_cfg, request_rate=args.rate,
                      prompt_len=args.prompt_len * 64, gen_len=args.max_new * 8)
    print(sp.describe())

    # 2. serve a runnable-scale model with continuous batching
    res = run_serving(scale_config(full_cfg, args.scale), device=args.device,
                      requests=args.requests, prompt_len=args.prompt_len,
                      max_new=args.max_new, max_batch=args.max_batch,
                      tp=args.tp)
    where = (f"{res['ranks']} ranks (rank 0 on {res['device']})"
             if args.tp is not None else res["device"])
    print(f"served {res['requests']} requests, {res['tokens']} tokens in "
          f"{res['wall_s']:.2f}s ({res['tokens_per_s']:.1f} tok/s) on "
          f"{where}")
    if args.tp is not None:
        print(f"collectives (rank 0, whole run): "
              f"{res['collectives']['counts']}, "
              f"{res['collectives']['total_wire_bytes']:.0f} wire bytes")
    print(f"TTFT p50 {res['ttft_p50_ms']:.0f} ms  "
          f"p99 {res['ttft_p99_ms']:.0f} ms;  "
          f"e2e p50 {res['e2e_p50_ms']:.0f} ms;  "
          f"prefill p50 {res['prefill_ms_p50']:.1f} ms, "
          f"decode step p50 {res['decode_ms_p50']:.1f} ms")
    return res


if __name__ == "__main__":
    main()
