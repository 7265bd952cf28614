#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the flash-attention kernel from csrc/ with nvcc;
3. kernel vs plain: the kernel's wrapper against the plain PyTorch version
   on the card at the serving shape and at GQA, q_offset and fp32 (TF32
   off) cases, with stated tolerances; then the kernel, the plain version
   and PyTorch's SDPA (a yardstick only; the port never calls it) are timed
   at the serving shape with CUDA events, beside the bound;
4. plan: ``plan_serving`` for minicpm-2b on the H100 datasheet hardware;
5. serve: 8 requests (prompt 1024, 32 new tokens, 4 slots) through
   ``run_serving`` at full minicpm-2b (40 layers, d_model 2304, bf16,
   weights drawn on the card from a seeded generator); the flash launch
   count over that run must be 40 per prefill; then one warm prefill and
   one batched decode step are traced with torch.profiler (device kernels,
   their summed time and its share of the step's wall time);
6. agreement: at a small size, prefill logits, KV cache and greedy tokens on
   the card agree with the same model run on the CPU.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 2 at once.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM datasheet peaks (dense): bf16 on the tensor cores, HBM3
# bandwidth.
PEAK_BF16 = 989e12
HBM_BW = 3.35e12

ARCH = "minicpm-2b"
REQUESTS, PROMPT_LEN, NEW_TOKENS, MAX_BATCH, SEED = 8, 1024, 32, 4, 0
TOLS = {torch.bfloat16: 2e-2, torch.float32: 2e-6}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    raise SystemExit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def causal_pairs(Sq: int, Skv: int, q_offset: torch.Tensor) -> int:
    """(query, key) pairs a causal pass over these rows must score."""
    rows = torch.arange(Sq)[None, :] + q_offset.cpu()[:, None].long()
    return int(torch.clamp(rows + 1, max=Skv).sum())


def profile_steps(eng, prompt: torch.Tensor, decode_batch: dict,
                  wall_ms: dict) -> None:
    """Trace one prefill and one batched decode step of the warm engine with
    torch.profiler: device kernels launched, their summed time, that time as
    a share of the step's unprofiled wall time (the engine's median), and
    the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = {
        "prefill": lambda: eng.api.prefill(eng.env, eng.params,
                                           {"tokens": prompt}),
        "decode": lambda: eng.api.decode_step(eng.env, eng.params, eng.cache,
                                              decode_batch),
    }
    for name, step in steps.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            print(f"profile [{name}]: the profiler saw no device kernels "
                  "(busy share not measured)")
            continue
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        busy_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(json.dumps({"profile": {
            "step": name, "device_kernels": len(kernels),
            "device_busy_ms": busy_ms, "wall_ms_p50": wall_ms[name],
            "busy_share": busy_ms / wall_ms[name],
            "top_ms": [[k[:100], v / 1e3] for k, v in top]}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.configs import get_config
    from repro_torch.distributed.roofline import H100_SXM
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.launch.serve import run_serving, scale_config
    from repro_torch.models import Env, get_model
    from repro_torch.serve import ServeEngine, plan_serving

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    # 1. device ---------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # 2. build ----------------------------------------------------------------
    rec = kernel.build()
    print(f"build: flash_fwd.cu in {rec['seconds']:.2f} s -> {rec['path']}")
    for line in str(rec["ptxas"]).splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(B, Sq, Skv, H, K, hd, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, Sq, H, hd), (B, Skv, K, hd),
                                   (B, Skv, K, hd)))

    def plain(q, k, v, q_offset):
        return reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), q_offset=q_offset
                                   ).transpose(1, 2)

    cases = [
        # name, B, Sq, Skv, H, K, hd, dtype, q_offset
        ("serving", 1, PROMPT_LEN, PROMPT_LEN, 36, 36, 64, torch.bfloat16, 0),
        ("gqa", 2, 200, 200, 8, 2, 128, torch.bfloat16, 0),
        ("q_offset", 2, 96, 256, 4, 4, 64, torch.float32, 160),
        ("fp32_hd112", 1, 333, 333, 4, 4, 112, torch.float32, 0),
    ]
    errors = {}
    for name, B, Sq, Skv, H, K, hd, dtype, off in cases:
        q, k, v = qkv(B, Sq, Skv, H, K, hd, dtype)
        q_offset = torch.full((B,), off, dtype=torch.int32, device=dev)
        out = ops.flash_attention(q, k, v, q_offset=q_offset)
        torch.cuda.synchronize()
        ref = plain(q, k, v, q_offset)
        tol = 1e-5 if off else TOLS[dtype]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool(torch.isfinite(out).all()) and out.shape == ref.shape and \
            bool((diff <= tol + tol * ref.float().abs()).all())
        errors[name] = err
        print(f"kernel vs plain [{name}] B={B} Sq={Sq} Skv={Skv} H={H} K={K} "
              f"hd={hd} {str(dtype)[6:]} q_offset={off}: max_abs_err {err:.3g} "
              f"(tol {tol:g} abs + rel) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"flash kernel disagrees with the plain version on {name}")

    # timing at the serving shape, in the kernel's layout
    B, S, H, hd = 1, PROMPT_LEN, 36, 64
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in qkv(B, S, S, H, H, hd, torch.bfloat16))
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)
    fns = {
        "kernel": lambda: kernel.flash_attention_fwd(q, k, v, q_offset=zero),
        "plain": lambda: reference_attention(q, k, v, q_offset=zero),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True),
    }
    samples = {n: [] for n in fns}
    for order in (("plain", "kernel", "library"), ("library", "kernel", "plain")):
        for n in order:
            samples[n].append(time_ms(fns[n]))
    ms = {n: sum(s) / len(s) for n, s in samples.items()}
    flops = 4.0 * B * H * causal_pairs(S, S, zero) * hd
    nbytes = 4 * q.numel() * q.element_size()       # q, k, v read; o written
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BW
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"flash timing at B={B} S={S} H=K={H} hd={hd} bf16 (mean of 2 "
          f"rounds of 20, ABBA): kernel_ms {ms['kernel']:.4f}  plain_ms "
          f"{ms['plain']:.4f}  library_ms (SDPA) {ms['library']:.4f}  "
          f"bound_ms {bound_ms:.5f} ({bound_by}; {flops:.4g} FLOP, "
          f"{nbytes} B)", flush=True)

    # 4. plan -------------------------------------------------------------------
    cfg = get_config(ARCH)
    sp = plan_serving(cfg, request_rate=4.0, prompt_len=PROMPT_LEN,
                      gen_len=NEW_TOKENS, hardware=H100_SXM)
    print(H100_SXM.describe())
    print(sp.describe())
    print(sp.schedule.describe(), flush=True)

    # 5. serve at full width and depth ---------------------------------------------
    kernel.reset_launch_count()
    res = run_serving(cfg, device="cuda", requests=REQUESTS,
                      prompt_len=PROMPT_LEN, max_new=NEW_TOKENS,
                      max_batch=MAX_BATCH, seed=SEED)
    launches = kernel.launch_count()
    expected = cfg.num_layers * REQUESTS
    done = res["done"]
    print(json.dumps({"serving": {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "requests": res["requests"], "prompt_len": PROMPT_LEN,
        "new_tokens": NEW_TOKENS, "max_batch": MAX_BATCH, "dtype": "bf16",
        "tokens": res["tokens"], "wall_s": res["wall_s"],
        "tokens_per_s": res["tokens_per_s"],
        "ttft_p50_ms": res["ttft_p50_ms"], "ttft_p99_ms": res["ttft_p99_ms"],
        "e2e_p50_ms": res["e2e_p50_ms"],
        "peak_mem_bytes": res["peak_mem_bytes"],
        "prefills": res["prefills"],
        "prefill_ms_first": res["prefill_ms_first"],
        "prefill_ms_p50": res["prefill_ms_p50"],
        "decode_steps": res["decode_steps"],
        "decode_ms_first": res["decode_ms_first"],
        "decode_ms_p50": res["decode_ms_p50"],
        "flash_launches": launches, "expected_launches": expected}}),
        flush=True)
    if launches != expected:
        fail(f"flash kernel launched {launches} times, expected {expected}")
    if len(done) != REQUESTS or any(len(r.output) != NEW_TOKENS for r in done):
        fail("not every request finished with its tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
        fail("a generated token is outside the vocabulary")
    eng = res["engine"]
    prompt = torch.as_tensor(done[0].prompt[None, :], dtype=torch.long,
                             device=dev)
    profile_steps(eng, prompt, {
        "tokens": prompt[:, :1].expand(MAX_BATCH, 1).contiguous(),
        "pos": torch.full((MAX_BATCH,), PROMPT_LEN + NEW_TOKENS, device=dev)},
        {"prefill": res["prefill_ms_p50"], "decode": res["decode_ms_p50"]})
    logits, _ = eng.api.prefill(eng.env, eng.params, {"tokens": prompt})
    if logits.shape != (1, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail("full-size prefill logits are not finite of shape (1, 1, V)")
    del eng, res, logits
    torch.cuda.empty_cache()

    # 6. agreement with the CPU at a small size ---------------------------------
    small = scale_config(cfg, "10m")
    api = get_model(small)
    cpu_params = api.init(torch.Generator().manual_seed(SEED), device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    envs = {"cpu": Env(torch.device("cpu"), torch.float32),
            "cuda": Env(dev, torch.float32)}
    params = {"cpu": cpu_params, "cuda": to(cpu_params, dev)}
    prompts = np.random.default_rng(SEED).integers(0, small.vocab_size, (5, 100))
    got = {}
    for name, env in envs.items():
        toks = torch.as_tensor(prompts[:1], dtype=torch.long, device=env.device)
        lg, cache = api.prefill(env, params[name], {"tokens": toks}, max_len=120)
        engine = ServeEngine(api, env, params[name], max_batch=2, max_len=120)
        for p, budget in zip(prompts, (6, 9, 4, 8, 5)):
            engine.submit(p, max_new_tokens=budget)
        outs = {r.rid: r.output for r in engine.run()}
        got[name] = (lg.cpu(), cache["k"].cpu(), cache["v"].cpu(), outs)
    logit_err = float((got["cpu"][0] - got["cuda"][0]).abs().max())
    cache_err = max(float((got["cpu"][i] - got["cuda"][i]).abs().max())
                    for i in (1, 2))
    same_tokens = got["cpu"][3] == got["cuda"][3]
    print(f"agreement at {small.name} fp32 (prompt 100): prefill logits "
          f"max_abs_err {logit_err:.3g}, cache {cache_err:.3g} (tol 1e-4); "
          f"greedy tokens of 5 requests equal: {same_tokens}", flush=True)
    if logit_err > 1e-4 or cache_err > 1e-4 or not same_tokens:
        fail("the port on the card disagrees with the same model on the CPU")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": launches,
        "max_abs_err": errors["serving"],
        "ms": ms["kernel"],
        "kernel_ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ms["library"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
