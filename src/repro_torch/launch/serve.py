"""Serving launcher: MBA+SAM plans the GPU split, the continuous-batching
engine serves batched requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \\
        --requests 12 --rate 4 --max-new 16            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --device cpu                                   # or zamba2-1.2b

Flags as the reference's ``python -m repro.launch.serve``, plus
``--device`` (default ``cuda``; there is no silent CPU fallback).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..models import default_env, get_model
from ..serve import ServeEngine, plan_serving
from .train import scale_config


def run_serving(cfg: ModelConfig, *, device: Optional[str] = None,
                requests: int = 12, prompt_len: int = 32, max_new: int = 16,
                max_batch: int = 4, seed: int = 0) -> Dict[str, object]:
    """Serve ``requests`` random prompts on ``cfg`` in bf16 with random
    weights drawn on the device from ``seed``; returns the finished requests
    (``done``), the engine and the run's metrics."""
    env = default_env(device)
    api = get_model(cfg)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    params = api.init(gen, device=env.device, dtype=env.compute_dtype)
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
    args = ap.parse_args(argv)

    # 1. the paper's technique: plan the GPU allocation for the FULL arch
    full_cfg = get_config(args.arch)
    sp = plan_serving(full_cfg, request_rate=args.rate,
                      prompt_len=args.prompt_len * 64, gen_len=args.max_new * 8)
    print(sp.describe())

    # 2. serve a runnable-scale model with continuous batching
    res = run_serving(scale_config(full_cfg, args.scale), device=args.device,
                      requests=args.requests, prompt_len=args.prompt_len,
                      max_new=args.max_new, max_batch=args.max_batch)
    print(f"served {res['requests']} requests, {res['tokens']} tokens in "
          f"{res['wall_s']:.2f}s ({res['tokens_per_s']:.1f} tok/s) on "
          f"{res['device']}")
    print(f"TTFT p50 {res['ttft_p50_ms']:.0f} ms  "
          f"p99 {res['ttft_p99_ms']:.0f} ms;  "
          f"e2e p50 {res['e2e_p50_ms']:.0f} ms;  "
          f"prefill p50 {res['prefill_ms_p50']:.1f} ms, "
          f"decode step p50 {res['decode_ms_p50']:.1f} ms")
    return res


if __name__ == "__main__":
    main()
