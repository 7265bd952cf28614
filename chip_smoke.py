#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the flash-attention and SSD-scan kernels from their
   csrc/ with nvcc, both at once; prints each kernel function's registers
   and spills from ptxas and its count of HMMA (tensor-core) instructions
   from ``cuobjdump -sass`` of the built library, by its demangled name;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, with stated tolerances.  bf16 runs the tensor-core kernels,
   fp32 the scalar ones.  Flash: the minicpm serving shape, zamba2-1.2b's
   shared-block shape, GQA, a ragged Sq = Skv = 33 and q_offset in bf16,
   q_offset and a padded hd in fp32 (TF32 off).  SSD: the mamba2-370m and
   zamba2-1.2b serving shapes, a padded (S=1000) and a short (S=100)
   prompt, an init_state case and two chained halves against one call, in
   bf16 and in fp32, and a narrow bf16 case (P=32, N=48, 6 heads).  Then each kernel, its plain version and, for flash,
   PyTorch's SDPA (a yardstick only; the port never calls it; no single
   PyTorch call computes SSD) are timed at the serving shape: device time
   from torch.profiler (the summed time of the device kernels 20 calls
   launch, per call) and, beside it, CUDA events around 20 calls in ABBA
   order (which include the host's gaps between launches);
4. plan: ``plan_serving`` for minicpm-2b, mamba2-370m and zamba2-1.2b on
   the H100 datasheet hardware;
5. serve: for each of the three models, 8 requests (prompt 1024, 32 new
   tokens, 4 slots) through ``run_serving`` at full width and depth (bf16,
   weights drawn on the card from a seeded generator), with both launch
   counts set to 0 just before and read just after: minicpm-2b 40 flash
   launches per prefill, mamba2-370m 48 SSD launches per prefill,
   zamba2-1.2b 38 SSD and 6 flash launches per prefill.  One warm prefill
   and one batched decode step of each model are traced with
   torch.profiler (device kernels, their summed time and its share of the
   step's wall time, the port's kernels by name);
6. agreement: for each family at a small size in fp32, prefill logits, the
   caches and greedy tokens of 5 ragged requests on the card agree with the
   same model run on the CPU.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 2 at once.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM datasheet peaks (dense): bf16 on the tensor cores, HBM3
# bandwidth.
PEAK_BF16 = 989e12
HBM_BW = 3.35e12

ARCHS = ("minicpm-2b", "mamba2-370m", "zamba2-1.2b")
REQUESTS, PROMPT_LEN, NEW_TOKENS, MAX_BATCH, SEED = 8, 1024, 32, 4, 0
TOLS = {torch.bfloat16: 2e-2, torch.float32: 2e-6}
# SSD: the reference's tolerances (tests/test_kernels.py)
SSD_Y_TOLS = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
SSD_STATE_TOL = 1e-3


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


def toolkit_tool(name: str):
    """The CUDA toolkit's ``name`` (on PATH or beside nvcc), or None."""
    nvcc = shutil.which("nvcc")
    tool = shutil.which(name) or (
        str(pathlib.Path(nvcc).parent / name) if nvcc else None)
    return tool if tool and pathlib.Path(tool).exists() else None


def kernel_label(demangled: str) -> str:
    """``name<template args>`` of a demangled kernel symbol, without its
    return type, anonymous namespace, argument list or integer casts:
    "void (anonymous namespace)::f<float, (int)64>(float const*, ...)" ->
    "f<float,64>"."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::"
                  r"|\((?:unsigned )?(?:int|long|short|char)\)", "", demangled)
    depth = 0
    for at, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            name = name[:at]
            break
    return name.replace(" ", "")


def demangle(symbols: list) -> list:
    """Kernel labels of mangled symbols, demangled by the toolkit's cu++filt
    (or binutils' c++filt); the symbols as they are when neither exists."""
    tool = toolkit_tool("cu++filt") or shutil.which("c++filt")
    if not tool or not symbols:
        return symbols
    out = subprocess.run([tool], input="\n".join(symbols), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return [kernel_label(s) for s in out] if len(out) == len(symbols) \
        else symbols


def ptxas_report(log: str) -> dict:
    """{kernel label: (registers, spill store bytes, spill load bytes)}
    from ``nvcc -Xptxas -v`` output."""
    rows, current, spills = [], None, (0, 0)
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[1].strip()
        elif current and "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = (int(found.group(1)), int(found.group(2))) if found else (-1, -1)
        elif current and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            rows.append((current, (int(regs.group(1)) if regs else -1, *spills)))
            current = None
    return dict(zip(demangle([sym for sym, _ in rows]), (r for _, r in rows)))


def sass_hmma_counts(library: str):
    """{kernel label: HMMA instructions} from ``cuobjdump -sass``, or None
    when the toolkit has no cuobjdump."""
    tool = toolkit_tool("cuobjdump")
    if not tool:
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300).stdout
    symbols, counts = [], []
    for line in out.splitlines():
        if "Function :" in line:
            symbols.append(line.split("Function :")[1].strip())
            counts.append(0)
        elif counts and "HMMA" in line:
            counts[-1] += 1
    return dict(zip(demangle(symbols), counts))


def device_ms(fn, iters: int = 20, warmup: int = 3):
    """Device time per call: the summed duration of the device kernels that
    ``iters`` calls launch, from torch.profiler, over ``iters``; and that
    time split by kernel label."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_label(e.name)
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    if not by_kernel:
        fail("the profiler saw no device kernels: device time not measured")
    return sum(by_kernel.values()), by_kernel


def time_abba(fns: dict, order: tuple) -> dict:
    """Mean ms of each function over two rounds, in ``order`` and then in
    reverse."""
    samples = {n: [] for n in fns}
    for names in (order, tuple(reversed(order))):
        for n in names:
            samples[n].append(time_ms(fns[n]))
    return {n: sum(s) / len(s) for n, s in samples.items()}


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def causal_pairs(Sq: int, Skv: int, q_offset: torch.Tensor) -> int:
    """(query, key) pairs a causal pass over these rows must score."""
    rows = torch.arange(Sq)[None, :] + q_offset.cpu()[:, None].long()
    return int(torch.clamp(rows + 1, max=Skv).sum())


def ssd_work(Bt: int, S: int, H: int, P: int, N: int, chunk: int,
             esize: int, with_init: bool):
    """Least FLOPs and bytes of one SSD scan.  FLOPs: per chunk of L
    positions, C.B^T over its causal L(L+1)/2 pairs once (B and C are shared
    by the heads), then per head the masked scores times x over the same
    pairs, the chunk's state summary (L x N x P) and, where the entering
    state is not zero, its term in y (L x N x P).  Bytes: x, B, C, dt, A
    (and init_state) read once, y and the final state written once."""
    Q = min(chunk, S)
    lengths = [min(Q, S - s0) for s0 in range(0, S, Q)]
    flops = 0
    for c, L in enumerate(lengths):
        pairs = L * (L + 1) // 2
        flops += 2 * Bt * N * pairs
        flops += 2 * Bt * H * (P * pairs + L * N * P)
        if c > 0 or with_init:
            flops += 2 * Bt * H * L * N * P
    nbytes = (2 * Bt * S * H * P * esize + 2 * Bt * S * N * esize
              + Bt * S * H * 4 + H * 4 + Bt * H * P * N * 4
              * (2 if with_init else 1))
    return float(flops), float(nbytes)


def profile_steps(eng, prompt: torch.Tensor, decode_batch: dict,
                  wall_ms: dict, ours: set) -> None:
    """Trace one warm prefill and one batched decode step of the engine
    with torch.profiler: device kernels launched, their summed time, that
    time as a share of the step's unprofiled wall time (the engine's
    median), the kernels that take the most of it, and the time of each of
    the port's kernels (those whose name before its template arguments is
    in ``ours``)."""
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
            print(f"profile [{eng.api.cfg.name} {name}]: the profiler saw no "
                  "device kernels (busy share not measured)")
            continue
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
        port_ms: dict = {}
        for k, us in by_name.items():
            label = kernel_label(k)
            if label.split("<")[0] in ours:
                port_ms[label] = port_ms.get(label, 0.0) + us / 1e3
        busy_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(json.dumps({"profile": {
            "arch": eng.api.cfg.name, "step": name,
            "device_kernels": len(kernels),
            "device_busy_ms": busy_ms, "wall_ms_p50": wall_ms[name],
            "busy_share": busy_ms / wall_ms[name],
            "port_kernels_ms": port_ms,
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
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
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

    # 2. build: one nvcc per source, started together ---------------------------
    sources = {"flash_fwd.cu": kernel, "ssd_fwd.cu": ssd_kernel}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = {name: pool.submit(mod.build) for name, mod in sources.items()}
        records = {name: f.result() for name, f in builds.items()}
    hmma, port_kernels = {}, set()
    for name, rec in records.items():
        print(f"build: {name} in {rec['seconds']:.2f} s -> {rec['path']}")
        report = ptxas_report(str(rec["ptxas"]))
        port_kernels |= {fn.split("<")[0] for fn in report}
        for fn, (regs, st, ld) in sorted(report.items()):
            print(f"  ptxas: {fn}: {regs} registers, {st} bytes spill stores, "
                  f"{ld} bytes spill loads")
        hmma[name] = sass_hmma_counts(rec["path"])
        if hmma[name] is None:
            print("  sass: cuobjdump is missing; HMMA not counted")
            continue
        for fn, n in sorted(hmma[name].items()):
            print(f"  sass: {fn}: {n} HMMA")
    sys.stdout.flush()

    # 3a. flash kernel vs plain ---------------------------------------------------
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
        ("zamba2_shared", 1, PROMPT_LEN, PROMPT_LEN, 32, 32, 64,
         torch.bfloat16, 0),
        ("gqa", 2, 200, 200, 8, 2, 128, torch.bfloat16, 0),
        ("bf16_ragged", 1, 33, 33, 4, 4, 64, torch.bfloat16, 0),
        ("bf16_q_offset", 2, 96, 256, 4, 4, 64, torch.bfloat16, 160),
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
        tol = 1e-5 if off and dtype == torch.float32 else TOLS[dtype]
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
    ev = time_abba(fns, ("plain", "kernel", "library"))
    ms = {n: device_ms(fn)[0] for n, fn in fns.items()}
    flops = 4.0 * B * H * causal_pairs(S, S, zero) * hd
    nbytes = 4 * q.numel() * q.element_size()       # q, k, v read; o written
    bound_ms, bound_by = bound(flops, nbytes)
    print(f"flash timing at B={B} S={S} H=K={H} hd={hd} bf16, device ms per "
          f"call (profiler, 20 calls): kernel {ms['kernel']:.6f}  plain "
          f"{ms['plain']:.6f}  library (SDPA) {ms['library']:.6f}; event ms "
          f"(mean of 2 rounds of 20, ABBA): kernel {ev['kernel']:.6f}  plain "
          f"{ev['plain']:.6f}  library {ev['library']:.6f}; bound_ms "
          f"{bound_ms:.6f} ({bound_by}; {flops:.4g} FLOP, {nbytes} B)",
          flush=True)
    del q, k, v, fns

    # 3b. SSD kernel vs plain -------------------------------------------------------
    def ssd_inputs(Bt, S, H, P, N, dtype, with_init=False):
        x = torch.randn((Bt, S, H, P), generator=gen, device=dev).to(dtype)
        dt = 0.01 + 0.19 * torch.rand((Bt, S, H), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
        Bm = torch.randn((Bt, S, N), generator=gen, device=dev).to(dtype)
        Cm = torch.randn((Bt, S, N), generator=gen, device=dev).to(dtype)
        init = (torch.randn((Bt, H, P, N), generator=gen, device=dev)
                if with_init else None)
        return (x, dt, A, Bm, Cm), init

    def ssd_check(name, got, want, y_tol, state_tol, desc):
        (y, fs), (y_ref, fs_ref) = got, want
        dy = (y.float() - y_ref.float()).abs()
        ds = (fs - fs_ref).abs()
        ok = (bool(torch.isfinite(y.float()).all()) and y.shape == y_ref.shape
              and y.dtype == y_ref.dtype and fs.shape == fs_ref.shape
              and bool((dy <= y_tol + y_tol * y_ref.float().abs()).all())
              and bool((ds <= state_tol + state_tol * fs_ref.abs()).all()))
        print(f"ssd kernel vs plain [{name}] {desc}: y max_abs_err "
              f"{float(dy.max()):.3g} (tol {y_tol:g} abs + rel), state "
              f"max_abs_err {float(ds.max()):.3g} (tol {state_tol:g}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"SSD kernel disagrees with the plain version on {name}")
        return float(dy.max())

    ssd_cases = [
        # name, Bt, S, H, P, N, chunk, dtype, init_state
        ("mamba2", 1, PROMPT_LEN, 32, 64, 128, 256, torch.bfloat16, False),
        ("zamba2", 1, PROMPT_LEN, 64, 64, 64, 256, torch.bfloat16, False),
        ("padded_bf16", 2, 1000, 8, 64, 128, 256, torch.bfloat16, False),
        ("short_bf16", 2, 100, 8, 64, 128, 256, torch.bfloat16, False),
        ("init_state_bf16", 2, 300, 8, 64, 64, 128, torch.bfloat16, True),
        ("narrow_bf16", 2, 200, 6, 32, 48, 64, torch.bfloat16, True),
        ("padded", 2, 1000, 8, 64, 128, 256, torch.float32, False),
        ("short", 2, 100, 8, 64, 128, 256, torch.float32, False),
        ("init_state", 2, 300, 8, 64, 64, 128, torch.float32, True),
    ]
    ssd_errors = {}
    for name, Bt, S, H, P, N, chunk, dtype, with_init in ssd_cases:
        args, init = ssd_inputs(Bt, S, H, P, N, dtype, with_init)
        got = ssd_ops.ssd_scan(*args, chunk=chunk, init_state=init)
        torch.cuda.synchronize()
        want = ssd_reference(*args, chunk=chunk, init_state=init)
        ssd_errors[name] = ssd_check(
            name, got, want, SSD_Y_TOLS[dtype], SSD_STATE_TOL,
            f"Bt={Bt} S={S} H={H} P={P} N={N} chunk={chunk} "
            f"{str(dtype)[6:]} init_state={with_init}")
    # two calls chained by state against one call: exact in fp32 up to the
    # order of sums; bf16 at the bf16 tolerances
    for dtype, y_tol, state_tol in ((torch.bfloat16, 5e-2, SSD_STATE_TOL),
                                    (torch.float32, 1e-4, 1e-4)):
        args, _ = ssd_inputs(1, PROMPT_LEN, 8, 64, 128, dtype)
        x, dt, A, Bm, Cm = args
        h = PROMPT_LEN // 2
        y1, s1 = ssd_ops.ssd_scan(x[:, :h], dt[:, :h], A, Bm[:, :h],
                                  Cm[:, :h], chunk=256)
        y2, s2 = ssd_ops.ssd_scan(x[:, h:], dt[:, h:], A, Bm[:, h:],
                                  Cm[:, h:], chunk=256, init_state=s1)
        full = ssd_ops.ssd_scan(*args, chunk=256)
        torch.cuda.synchronize()
        ssd_check(f"chained_halves_{str(dtype)[6:]}",
                  (torch.cat([y1, y2], dim=1), s2), full, y_tol, state_tol,
                  f"two calls of S={h} chained by state vs one of "
                  f"S={PROMPT_LEN}, H=8 P=64 N=128 chunk=256 {str(dtype)[6:]}")

    # timing at the mamba2-370m serving shape
    Bt, S, H, P, N, chunk = 1, PROMPT_LEN, 32, 64, 128, 256
    (x, dt, A, Bm, Cm), _ = ssd_inputs(Bt, S, H, P, N, torch.bfloat16)
    fns = {
        "kernel": lambda: ssd_kernel.ssd_scan_fwd(x, dt, A, Bm, Cm,
                                                  chunk=chunk),
        "plain": lambda: ssd_reference(x, dt, A, Bm, Cm, chunk=chunk),
    }
    ssd_ev = time_abba(fns, ("plain", "kernel"))
    ssd_ms, ssd_passes = device_ms(fns["kernel"])
    ssd_plain_ms = device_ms(fns["plain"])[0]
    ssd_flops, ssd_bytes = ssd_work(Bt, S, H, P, N, chunk, 2, False)
    ssd_bound_ms, ssd_bound_by = bound(ssd_flops, ssd_bytes)
    print(f"ssd timing at Bt={Bt} S={S} H={H} P={P} N={N} chunk={chunk} bf16, "
          f"device ms per call (profiler, 20 calls): kernel {ssd_ms:.6f} ("
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(ssd_passes.items()))
          + f")  plain {ssd_plain_ms:.6f}; event ms (mean of 2 rounds of 20, "
          f"ABBA): kernel {ssd_ev['kernel']:.6f}  plain {ssd_ev['plain']:.6f}; "
          f"library none (no single PyTorch call computes SSD); bound_ms "
          f"{ssd_bound_ms:.6f} ({ssd_bound_by}; {ssd_flops:.4g} FLOP, "
          f"{ssd_bytes:.0f} B)", flush=True)
    del x, dt, A, Bm, Cm, args, full, y1, y2, s1, s2, fns
    torch.cuda.empty_cache()

    # 4. plan -------------------------------------------------------------------
    print(H100_SXM.describe())
    for arch in ARCHS:
        sp = plan_serving(get_config(arch), request_rate=4.0,
                          prompt_len=PROMPT_LEN, gen_len=NEW_TOKENS,
                          hardware=H100_SXM)
        print(f"[{arch}] {sp.describe()}")
        print(sp.schedule.describe(), flush=True)

    # 5. serve at full width and depth ---------------------------------------------
    counters = {"flash": kernel, "ssd": ssd_kernel}
    launches = {name: {} for name in counters}
    for arch in ARCHS:
        cfg = get_config(arch)
        n_shared = cfg.num_layers // cfg.attn_period if cfg.attn_period else 0
        per_prefill = {
            "flash": cfg.num_layers if cfg.family == "dense" else n_shared,
            "ssd": cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0}
        for mod in counters.values():
            mod.reset_launch_count()
        res = run_serving(cfg, device="cuda", requests=REQUESTS,
                          prompt_len=PROMPT_LEN, max_new=NEW_TOKENS,
                          max_batch=MAX_BATCH, seed=SEED)
        counts = {name: mod.launch_count() for name, mod in counters.items()}
        expected = {name: n * REQUESTS for name, n in per_prefill.items()}
        for name, n in counts.items():
            launches[name][arch] = n
        done = res["done"]
        print(json.dumps({"serving": {
            "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model,
            "requests": res["requests"], "prompt_len": PROMPT_LEN,
            "new_tokens": NEW_TOKENS, "max_batch": MAX_BATCH, "dtype": "bf16",
            "tokens": res["tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens_per_s"],
            "ttft_p50_ms": res["ttft_p50_ms"],
            "ttft_p99_ms": res["ttft_p99_ms"],
            "e2e_p50_ms": res["e2e_p50_ms"],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "prefills": res["prefills"],
            "prefill_ms_first": res["prefill_ms_first"],
            "prefill_ms_p50": res["prefill_ms_p50"],
            "decode_steps": res["decode_steps"],
            "decode_ms_first": res["decode_ms_first"],
            "decode_ms_p50": res["decode_ms_p50"],
            "flash_launches": counts["flash"],
            "ssd_launches": counts["ssd"],
            "expected_launches": expected}}), flush=True)
        if counts != expected:
            fail(f"{arch}: kernel launches {counts}, expected {expected}")
        if len(done) != REQUESTS or any(len(r.output) != NEW_TOKENS
                                        for r in done):
            fail(f"{arch}: not every request finished with its tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            fail(f"{arch}: a generated token is outside the vocabulary")
        eng = res["engine"]
        prompt = torch.as_tensor(done[0].prompt[None, :], dtype=torch.long,
                                 device=dev)
        profile_steps(eng, prompt, {
            "tokens": prompt[:, :1].expand(MAX_BATCH, 1).contiguous(),
            "pos": torch.full((MAX_BATCH,), PROMPT_LEN + NEW_TOKENS,
                              device=dev)},
            {"prefill": res["prefill_ms_p50"],
             "decode": res["decode_ms_p50"]}, port_kernels)
        logits, _ = eng.api.prefill(eng.env, eng.params, {"tokens": prompt})
        if logits.shape != (1, 1, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{arch}: full-size prefill logits are not finite of shape "
                 "(1, 1, V)")
        del eng, res, logits, done, prompt
        torch.cuda.empty_cache()

    # 6. agreement with the CPU at a small size ---------------------------------
    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    envs = {"cpu": Env(torch.device("cpu"), torch.float32),
            "cuda": Env(dev, torch.float32)}
    prompts = np.random.default_rng(SEED).integers(0, 8192, (5, 100))
    for arch in ARCHS:
        small = scale_config(get_config(arch), "10m")
        if small.family == "ssm":      # several chunks, the last one ragged
            small = dataclasses.replace(small, ssm_chunk=32)
        if small.family == "hybrid":   # the shared block runs at 4 layers
            small = dataclasses.replace(
                small, attn_period=small.num_layers // 2)
        api = get_model(small)
        cpu_params = api.init(torch.Generator().manual_seed(SEED),
                              device="cpu")
        params = {"cpu": cpu_params, "cuda": to(cpu_params, dev)}
        got = {}
        for name, env in envs.items():
            toks = torch.as_tensor(prompts[:1], dtype=torch.long,
                                   device=env.device)
            lg, cache = api.prefill(env, params[name], {"tokens": toks},
                                    max_len=120)
            engine = ServeEngine(api, env, params[name], max_batch=2,
                                 max_len=120)
            for p, budget in zip(prompts, (6, 9, 4, 8, 5)):
                engine.submit(p, max_new_tokens=budget)
            outs = {r.rid: r.output for r in engine.run()}
            got[name] = (lg.cpu(), {k: t.cpu() for k, t in cache.items()},
                         outs)
        logit_err = float((got["cpu"][0] - got["cuda"][0]).abs().max())
        cache_err = {k: float((t - got["cuda"][1][k]).abs().max())
                     for k, t in got["cpu"][1].items()}
        same_tokens = got["cpu"][2] == got["cuda"][2]
        print(f"agreement at {small.name} fp32 (prompt 100"
              + (f", ssm_chunk {small.ssm_chunk}" if small.ssm_state else "")
              + (f", attn_period {small.attn_period}" if small.attn_period
                 else "")
              + f"): prefill logits max_abs_err {logit_err:.3g}, cache "
              + ", ".join(f"{k} {e:.3g}" for k, e in sorted(cache_err.items()))
              + f" (tol 1e-4); greedy tokens of 5 requests equal: "
              f"{same_tokens}", flush=True)
        if logit_err > 1e-4 or max(cache_err.values()) > 1e-4 or \
                not same_tokens:
            fail(f"{arch}: the port on the card disagrees with the same "
                 "model on the CPU")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": sum(launches["flash"].values()),
        "launches_by_path": launches["flash"],
        "max_abs_err": errors["serving"],
        "ms": ms["kernel"],
        "kernel_ms": ms["kernel"],
        "event_ms": ev["kernel"],
        "plain_ms": ms["plain"],
        "plain_event_ms": ev["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ms["library"],
        "library_event_ms": ev["library"],
        "hmma": hmma["flash_fwd.cu"],
    }, {
        "name": "ssd_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
        "launches": sum(launches["ssd"].values()),
        "launches_by_path": launches["ssd"],
        "max_abs_err": ssd_errors["mamba2"],
        "ms": ssd_ms,
        "kernel_ms": ssd_ms,
        "kernel_ms_by_pass": ssd_passes,
        "event_ms": ssd_ev["kernel"],
        "plain_ms": ssd_plain_ms,
        "plain_event_ms": ssd_ev["plain"],
        "bound_ms": ssd_bound_ms,
        "bound_by": ssd_bound_by,
        "library_ms": None,
        "hmma": hmma["ssd_fwd.cu"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
