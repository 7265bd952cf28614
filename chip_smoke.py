#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the flash-attention, SSD-scan, grouped-expert,
   decode-attention, sweep and stream-operator kernels from their csrc/
   with nvcc, all at once; prints each kernel
   function's registers
   and spills from ptxas and its count of HMMA (tensor-core) instructions
   from ``cuobjdump -sass`` of the built library, by its demangled name;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, with stated tolerances.  bf16 runs the tensor-core kernels,
   fp32 the scalar ones.  Flash: the minicpm serving shape, zamba2-1.2b's
   shared-block shape, GQA, a ragged Sq = Skv = 33 and q_offset in bf16,
   q_offset and a padded hd in fp32 (TF32 off), and in bf16 at the serving
   prompt the shapes of the other served models: whisper's decoder (H = K
   = 20, hd 64), phi-3-vision's (H = K = 32, hd 96 padded to 128),
   kimi-k2's (H 64, K 8, hd 112 padded) and qwen2.5-32b's (H 40, K 8: a
   GQA group of 5).  Then flash's non-causal mode (``causal=False``, which
   no served model calls: the reference sends only causal attention to
   its kernel), driven through ``ops.flash_attention`` with the launch
   count set to 0 just before and read just after: whisper-large-v3's
   encoder self-attention (S 1500, H = K = 20, hd 64) in bf16 and fp32, a
   cross-attention of the serving prompt over its 1500 frames, GQA, a
   ragged Sq = Skv = 33, and a q_offset of 160 that must give its offset
   0 output bit for bit; each held against the plain version; the mode is
   timed at the encoder shape beside SDPA and its bound (FLOPs not
   halved).  SSD: the mamba2-370m and
   zamba2-1.2b serving shapes, a padded (S=1000) and a short (S=100)
   prompt, an init_state case and two chained halves against one call, in
   bf16 and in fp32, and a narrow bf16 case (P=32, N=48, 6 heads).  Then each kernel, its plain version and, for flash,
   PyTorch's SDPA (a yardstick only; the port never calls it; no single
   PyTorch call computes SSD) are timed at the serving shape: device time
   from torch.profiler (the summed time of the device kernels 20 calls
   launch, per call) and, beside it, CUDA events around 20 calls in ABBA
   order (which include the host's gaps between launches).  3c holds
   the grouped experts and the grouped SSD at nemotron-3-nano's widths;
   3d the split-KV decode-attention kernel at the cells' decode shapes
   (minicpm-2b's 16 slots over 4136 and 1544 positions, nemotron-3-nano's
   64 over 1544 with G = 16), every slot full and at drawn lengths: the
   kernel against its plain version (bf16 tolerance), its device time
   (profiler; events beside it) against the bytes of the live cache, the
   plain version's time and SDPA with a length mask (a yardstick only);
4. plan: ``plan_serving`` for all ten architectures on the H100 datasheet
   hardware;
5. serve: for each of the ten models, 8 requests (prompt 1024, 32 new
   tokens, 4 slots) through ``run_serving`` at full width (bf16, weights
   drawn on the card from a seeded generator; whisper with its 1500 zero
   stand-in frames, phi-3-vision with 576 zero patch embeddings) and full
   depth, but for qwen2-72b (32 of 80 layers) and kimi-k2 (1 of 61, all
   384 experts), which one 80 GB card cannot hold whole; both launch
   counts set to 0 just before and read just after.  Flash launches per
   prefill: one per attention layer (minicpm 40, minitron 32, qwen2.5 64,
   qwen2-72b 32, moonshot 48, kimi 1, phi-3-vision 32), whisper's 32
   decoder self-attentions, zamba2's 6 shared blocks; SSD: mamba2 48,
   zamba2 38.  The decode-attention kernel runs once in each layer
   holding a K/V cache (the layers flash runs in a prefill) at each of the
   engine's eager warm-up decode steps and its graph capture, and the
   ``attn.decode_kernel_calls`` counter (metrics enabled for the run) says
   the same.  Peak device memory stays under 80 GB.  One warm prefill
   and one batched decode step of each model are traced with
   torch.profiler (device kernels, their summed time and its share of the
   step's wall time, the port's kernels by name);
6. agreement: for each family (dense, ssm, hybrid, moe, vlm, audio) at a
   small size in fp32, prefill logits (whisper and phi-3-vision on seeded
   frames / patch embeddings), every cache entry and greedy tokens of 5
   ragged requests on the card agree with the same model run on the CPU;
   for moe, every routing decision (the top-k experts of each token) is
   equal, and the smallest gap between a token's k-th and (k+1)-th router
   probability is printed;
7. scheduler: each of the six seed DAGs, planned at 100 t/s with mba/sam,
   is swept over ``benchmarks/bench_sweep.py``'s grid (50 rates from 10 to
   150 t/s, 60 s at dt 0.05) by ``DataflowSimulator.sweep_raw`` on the
   sweep kernel, with the launch count set to 0 just before the six sweeps
   and read just after (one launch each).  Every raw field agrees with the
   port's numpy engine and with the kernel's plain PyTorch version on the
   card (the same tensors) to 1e-10; verdicts and ``max_stable_rate`` are
   equal; one SweepBatch co-simulation of two DAGs on a shared pool agrees
   with numpy.  Then ``plan(mapper="search")`` for traffic, finance and grid
   at 50 and 100 t/s, with the count set to 0 just before each: the winner
   and the rank order equal the numpy engine's search, the launches equal
   the shape buckets, the buckets are the reference's power-of-two ones,
   and every bucket's kernel outputs (candidates on the grid's y axis,
   padded groups) agree with the plain version on the same card tensors to
   1e-10, field by field.  Every sweep and bucket line carries the
   kernel's launch shape (warps and dynamic shared memory per block, the
   rows' skew, the waves) and the sweep lines its registers and spills
   (ptxas) and its critical path in dependent float64 operations per tick
   (``sweep_chain``: a wave's, and row after row's for comparison).  The
   kernel is timed by device time (profiler) and CUDA events at the grid
   sweep and the grid search's buckets, beside the plain version's event
   time on the same tensors and the numpy engine's host time, with ns per
   critical-path operation; one ``{"scheduler": ...}`` line carries it
   all.  One untimed sweep runs first, so that every timed one is warm;
8. fleet: ``plan_fleet`` (max_min, sam) on ``benchmarks/bench_fleet.py``'s
   cycled seed DAGs at 2, 3, 4 and 6 DAGs (budgets 16, 32, 64, 64), at 8
   and 12 (96, 128) and at 24 (256: its state no longer fits a block's
   shared memory), each co-simulated once by ``simulate_fleet`` on the
   sweep kernel (after one untimed warm-up co-simulation), with the launch
   count set to 0 just before and read just after (exactly one launch):
   every ``SweepRaw`` field, each DAG's actual max stable and predicted
   max rate and verdicts, slot busy and per-VM CPU and memory agree with
   ``engine="numpy"`` to 1e-10, and the kernel's outputs with its plain
   version on the same card tensors to 1e-13 (abs + rel).  Each fleet's
   line gives T, G, S, L, the launch shape (warps, skew, the longest
   DAG's rows that set the lag, waves, bytes a block and whether they sit
   in shared or device memory), the kernel's and numpy's wall ms and the
   kernel's device ms beside its bound.
   Then ``benchmarks/bench_online.py``'s 20-event day (budget 44, sam,
   step 2) is replayed through ``FleetController.replay(simulate=True)`` on
   the kernel and on numpy: the per-event planned rates and stable verdicts
   must be equal, and the launches equal the co-simulations that ran; one
   ``cosimulate(prove=True)`` prints its engine and proved verdicts.  One
   ``{"fleet": ...}`` line carries it all;
9. stream: the streaming runtime on the card.  (a) The four operator
   kernels (parse_xml, viete_pi, rolling_digest, external_service) against
   their plain versions on the card at parts of 1, 7, 16, 32, 33 and 1024
   tuples of 256 bytes drawn as ``SyntheticSource`` draws them, a part of
   16 negative values and one whose service chain wraps at 1000, the
   digest on the float, the checksum and the negated checksum columns:
   every output equal (tolerance 0).  parse_xml also runs on seeded bytes
   0-255 through both paths of its kernel (the vector path at L = 256; the
   byte path at L = 255 and at an odd byte offset), each path's launches
   counted; the digest also runs past one block's reach (200,000 and
   300,000 tuples, its tile totals in device memory), one counted launch
   a call.  Each
   is timed at a frame's part (16 tuples) and at 1024 (the digest also at
   200,000) by profiler device
   time and CUDA events beside its plain version, its roofline bound
   (bytes, and its FP32-rate operations), and its latency floor: its
   dependent chain's steps at the cycles ``chain_probe.cu`` measures for
   each kind of step, at the SM clock nvidia-smi reports, after the larger
   of an empty kernel's device time and the part's first read (an
   estimate, not a lower bound).  The host's launch path is split piece by piece
   (ns a call over 10,000 calls at 16 tuples).  (b)
   ``benchmarks/bench_chaos.py``'s 20-event day (4 tenants on 40 slots, 12
   frames an event, batch 16, its seeded FaultPlan and the correlated crash
   of two VMs) through ``LiveFleet`` on a VirtualClock on the card and on
   the CPU: records, rates, fault timeline, reports, escalations and
   rebinds equal, and the kernel launches equal the executors' operator
   calls of their kinds.  (c) The recalibration rails on the card and the
   CPU: bench_chaos's 2x mis-profiled tables (0.50 -> 0.0909) and
   tests/test_obs.py's auto-recalibrating fleet (0.357 -> 0.065 at tick
   0), with sweep launches equal to the co-simulations ``drift`` ran.  (d)
   Each seed DAG planned at 100 t/s (mba/sam) streams 200 frames of 16 at
   that rate on the card under a WallClock (throughput, mean and p99
   latency, stability, shed and timed-out frames, launches a frame), and
   diamond climbs a ladder of planned rates (100, 1000, 5000, 20000 t/s);
   one warm diamond frame is traced (device kernels, device and wall ms).
   Each path runs with the launch counts set to 0 just before and read
   just after; every parse_xml launch among them must take the vector
   path.  One ``{"stream": ...}`` line carries it all;
10. train: (a) flash at minicpm-2b's training shape (B 4, S 1024, H = K =
   36, hd 64) and a GQA one (32/8, hd 128), SSD at mamba2-370m's (Bt 4,
   S 1024, H 32, P 64, N 128, chunk 256), all bf16 under autograd: the
   forward against the plain version at phase 3's tolerances, the
   gradients (the backward recomputes through the plain version) against
   autograd through the plain version on the same inputs; one causal
   attention's forward and backward timed through the port's op, the
   plain version and SDPA (a yardstick only).  (b-c) minicpm-2b and
   mamba2-370m trained through ``launch/train.py``'s ``run_training`` at
   full width and depth (bf16 compute over fp32 master params and AdamW
   state, remat, the config's schedule, batch 4 x seq 1024, 8 steps on
   ``SyntheticTokens``, weights drawn on the card from a seed), both
   launch counts set to 0 just before and read just after: flash 2 x 40
   and SSD 2 x 48 a step (remat runs each layer's forward twice); step
   time p50, tokens/s, peak device memory, the first and last loss, and
   one traced step (device kernels, busy share, top kernels) in one
   ``{"train": ...}`` and one ``{"profile": ...}`` line each.  (d) For
   each family at a small size in fp32, one train step on the card
   against the same step on the CPU: loss, every gradient, the new params
   and moments; MoE's routing decisions equal.  (e) A reduced minicpm
   (bf16, bf16 ``mu``) saved after step 2, restored into a freshly drawn
   state on the card bit-equal to what was saved, and its next two losses
   against the uninterrupted run's;
11. analysis: the static-analysis CLI (``python -m repro_torch.analysis``)
   run in process through its ``main``.  ``prove --simulate`` at the CLI's
   defaults (12 slots, 300 t/s: what the reference's CI runs) and at 120
   slots / 3000 t/s, each with the launch count set to 0 just before and
   read just after (exactly one sweep launch: the planned fleet's
   co-simulation): the exit code and every ``prove:`` line equal the same
   call with ``--device cpu``, the reference's decided cells (27 of 27,
   21 of 27) and 0 RATE309 mismatches; the recorded kernel call against
   its plain version on the same card tensors (1e-13 abs + rel), the
   co-simulation's raw fields against ``engine="numpy"`` (1e-10) and its
   stable verdicts equal; the one launch's device ms beside its bound,
   the plain version's and numpy's times.  ``--verify-smoke`` exits 0
   clean; ``lint src/``, ``flow src/`` and ``flow src/ tests/ benchmarks/
   --sarif`` exit 0 with no findings (lint + flow over src/ under the
   reference CI's 30 s budget); ``flow tests/fixtures/flow/`` exits 1 with
   the codes the reference's tests expect of its three fixtures.  Each
   command's wall ms and one ``{"analysis": ...}`` line are printed.

12. sharded: serving sharded over R = ``torch.cuda.device_count()``
   rank processes, one card each over NCCL, started by the launcher's
   spawn helper (``repro_torch.distributed.spawn``) and run through its
   rank entry; each rank draws only its shard of the weights.  Every job
   holds each rank's flash and SSD launches exact (counts set to 0 just
   before its serving run, read just after), every rank's greedy tokens
   equal, its peak memory under 80 GB and a dense model's collectives
   (prefill, decode step, whole run) equal to the analytic count.  On one
   card: minicpm-2b at full width and depth at tp 1 (an NCCL group of
   one), its tokens equal to phase 5's and its prefill logits within bf16
   tolerance.  On four: minicpm-2b at tp 4 (9 heads a rank), its fp32
   tokens equal to the one-device model's; qwen2-72b at all 80 layers (16
   query and 2 KV heads a rank); moonshot-v1-16b-a3b expert-parallel (16
   experts a rank), every rank's routing and drops equal to rank 0's
   recomputation from each layer's input; mamba2-370m (8 SSD heads a
   rank); a 4-stage gpipe against the layers in sequence.  It prints the
   ranks and the jobs it ran and did not run, one ``{"sharded": ...}``
   line a job (tokens/s, prefill and decode ms, collectives and their
   bytes per prefill and decode step, each rank's peak memory).  Phase 3
   also holds flash at one rank's heads of minicpm, qwen2-72b and
   moonshot at tp 4, and SSD at one rank's 8 mamba2 heads.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 2 at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent

# NVIDIA H100 SXM datasheet peaks (dense): bf16 on the tensor cores, HBM3
# bandwidth.
PEAK_BF16 = 989e12
HBM_BW = 3.35e12
# FP64 outside the tensor cores (the sweep kernel's scalar float64 work)
PEAK_FP64 = 34e12
# FP32 outside the tensor cores (the stream operators' scalar work; their
# integer operations are counted at this rate too, the data sheet giving
# no int32 rate)
PEAK_FP32 = 67e12

# phase 5: every architecture the port serves, in the reference's order,
# at full width; two cut in depth (layers kept of the published count)
# because one 80 GB card cannot hold them whole: qwen2-72b to one stage of
# the two-card prefill that plan_serving gives it (40 of 80), kimi-k2 to the
# most layers whose weights fit (2 of 61, 73.0 GB in bf16)
SERVED = ("minicpm-2b", "minitron-4b", "qwen2.5-32b", "qwen2-72b",
          "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "zamba2-1.2b",
          "whisper-large-v3", "mamba2-370m", "phi-3-vision-4.2b",
          # the port's own: hybrid_moe, whole (31.58 B parameters, 63.16 GB)
          "nemotron-3-nano-30b-a3b")
DEPTH_CUTS = {"qwen2-72b": 40, "kimi-k2-1t-a32b": 2}
CARD_BYTES = 80e9
# phase 6: one architecture of each family
AGREEMENT = ("minicpm-2b", "mamba2-370m", "zamba2-1.2b",
             "moonshot-v1-16b-a3b", "phi-3-vision-4.2b", "whisper-large-v3")
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
    return type, anonymous namespace, argument list or integer casts, bool
    arguments spelt false / true:
    "void (anonymous namespace)::f<float, (int)64>(float const*, ...)" ->
    "f<float,64>"."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::"
                  r"|\((?:unsigned )?(?:int|long|short|char)\)", "", demangled)
    name = name.replace("(bool)0", "false").replace("(bool)1", "true")
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


def device_ms(fn, iters: int = 20, warmup: int = 3, required: bool = True):
    """Device time per call: the summed duration of the device kernels that
    ``iters`` calls launch, from torch.profiler, over ``iters``; and that
    time split by kernel label.  A trace that shows no device kernel is
    taken once more; if that one shows none either, the events it did see
    are counted by device type, and the call fails, or with ``required``
    off returns (None, {})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_kernel: dict = {}
        kinds: dict = {}
        for e in prof.events():
            kinds[str(e.device_type)] = kinds.get(str(e.device_type), 0) + 1
            if e.device_type == DeviceType.CUDA:
                name = kernel_label(e.name)
                by_kernel[name] = (by_kernel.get(name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / iters)
        if by_kernel:
            return sum(by_kernel.values()), by_kernel
        print(f"profiler trace {attempt}: no device kernel among its events "
              f"{kinds}", flush=True)
    if required:
        fail("the profiler saw no device kernels: device time not measured")
    return None, {}


def sweep_device_ms(fn, iters: int = 20) -> tuple:
    """(ms per call, its source) of a sweep kernel launch: the device time
    of the kernels named ``sweep`` from the profiler, or, where the
    profiler shows no device kernel, CUDA events around the calls."""
    _, by_kernel = device_ms(fn, iters=iters, required=False)
    if by_kernel:
        return (sum(v for k, v in by_kernel.items() if "sweep" in k),
                "device (profiler)")
    return time_ms(fn, iters=iters), "events (the profiler saw no kernel)"


def time_abba(fns: dict, order: tuple) -> dict:
    """Mean ms of each function over two rounds, in ``order`` and then in
    reverse."""
    samples = {n: [] for n in fns}
    for names in (order, tuple(reversed(order))):
        for n in names:
            samples[n].append(time_ms(fns[n]))
    return {n: sum(s) / len(s) for n, s in samples.items()}


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
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


def profile_steps(eng, prefill_batch: dict, decode_batch: dict,
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
                                           prefill_batch),
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

SWEEP_OMEGAS = np.linspace(10.0, 150.0, 50)       # benchmarks/bench_sweep.py
SWEEP_KW = dict(duration=60.0, dt=0.05)
SEARCH_DAGS, SEARCH_RATES = ("traffic", "finance", "grid"), (50.0, 100.0)
SWEEP_TOL = 1e-10                                  # tests/test_simulator_scan.py
RAW_FIELDS = ("queues", "busy", "served", "realized", "latency")


@contextlib.contextmanager
def recorded_calls(module, name: str):
    """Record the arguments and result of every call of ``module.name`` as
    ``(args, kw, out)`` (calls go through unchanged)."""
    calls, original = [], getattr(module, name)

    def record(*args, **kw):
        out = original(*args, **kw)
        calls.append((args, kw, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def sweep_work(structure, caps: np.ndarray, counts: np.ndarray, steps: int,
               s0: int, n_samples: int):
    """Least float64 operations and bytes of one sweep launch on this run's
    data (real groups only: ``counts`` (C, T) per candidate), and the
    operations of one column.  Per column: cap dt once per group; per tick
    2 per in-edge (multiply, add), 6 per group (arrivals, their dt product,
    the queue add, min, subtract, the row sum) and a divide per row with
    groups; per window tick 1 per group (served) and 2 per group with
    cap > 0 (divide, busy add); per sample 4 per group with cap > 0, 2 per
    in-edge, an add per row with in-edges and the sink maxima.  Bytes:
    every input read once, every output written once."""
    C, G, K = caps.shape
    rows, edges = structure.row_slices, structure.in_edges
    T, E, S, n_out = len(rows), structure.n_edges, structure.n_slots, \
        structure.n_out
    window = max(steps - s0, 0)
    live = counts.sum(axis=1)                        # real groups, (C,)
    per_column = ((1 + 6 * steps + window) * live
                  + steps * (2 * E + sum(hi > lo for lo, hi in rows))
                  + n_samples * (2 * E + sum(bool(e) for e in edges)
                                 + sum(max(len(r) - 1, 0)
                                       for r in structure.sink_groups)))
    real = np.zeros((C, G), dtype=bool)
    for r, (lo, _) in enumerate(rows):
        for c in range(C):
            real[c, lo:lo + counts[c, r]] = True
    n_pos = int(((caps > 0) & real[:, :, None]).sum())
    flops = K * int(per_column.sum()) + (2 * window + 4 * n_samples) * n_pos
    n_sink_rows = sum(len(r) for r in structure.sink_groups)
    nbytes = (8 * C * G * K + 8 * T * K + 12 * C * G + 8 * C * E + 4 * C * T
              + 4 * (2 * (T + 1) + E + n_out + 1 + n_sink_rows) + 8 * E
              + 8 * C * K * (2 * G + S + T + n_samples * n_out))
    return float(flops), float(nbytes), float(per_column.mean())


def sweep_chain(structure, counts: np.ndarray, g_slot: np.ndarray) -> dict:
    """Dependent float64 operations of one tick on the kernel's critical
    path, for the candidate with the longest.  A row's chain: with in-edges
    the first product and an add per edge; with groups the arrivals, their
    dt product, the queue add, the min, an add per real group (the row's
    ordered sum) and the divide's 5 (``div_by``).  The kernel's waves
    advance every row by one tick, so a tick costs the longest row's chain
    plus the busy walk of the slot with the most real groups (an add per
    group): ``wave``.  A tick done row after row costs the sum of the rows'
    chains: ``serial``, for comparison."""
    rows = [(1 + len(e) if e else 0) for e in structure.in_edges]
    spans = [hi > lo for lo, hi in structure.row_slices]
    wave = serial = 0
    for c, row in enumerate(counts):
        chains = [edge + (9 + int(n) if has else 0)
                  for edge, n, has in zip(rows, row, spans)]
        slots = [int(g_slot[c, lo + j]) for (lo, _), n in
                 zip(structure.row_slices, row) for j in range(int(n))]
        walk = max(np.bincount(slots).max() if slots else 0, 0)
        wave, serial = max(wave, max(chains) + walk), max(serial, sum(chains))
    return {"wave": int(wave), "serial": int(serial)}


def launch_report(sweep_kernel, args, kw) -> dict:
    """The sweep kernel's launch shape for one call's inputs: warps per
    block, the rows' skew, the bytes of a block's layout and where they
    live (shared memory, or a device-memory scratch), blocks and waves (the
    rows lag within their segment: a fleet's DAGs each from their own
    first row)."""
    caps, counts, structure = args[0], args[5], args[6]
    C, G, K = caps.shape
    warps, skew, nbytes, where = sweep_kernel.launch_shape(
        G, structure.n_slots, structure.n_rows, structure.n_edges,
        structure.n_out, int(structure.sink_rows.numel()),
        int(counts.sum(dim=1).max()), K, kw["sample_every"],
        structure.lag_rows)
    steps = kw["steps"]
    return {"warps_per_block": warps, "skew": skew,
            "shared_bytes_per_block": nbytes if where == "shared" else 0,
            "layout_bytes_per_block": nbytes, "placement": where,
            "lag_rows": structure.lag_rows, "blocks": -(-K // warps) * C,
            "waves": steps + skew * (structure.lag_rows - 1) if steps else 0}


def pow2_buckets(search_mod, dag, alloc, lib, ranked) -> list:
    """Candidates per shape bucket as the reference's vmapped engine forms
    them (``repro/core/search.py:281-290``), from the search's pool."""
    from repro_torch.core.predictor import build_group_index

    def p2(n: int) -> int:
        return 1 if n <= 1 else 1 << (n - 1).bit_length()

    buckets: dict = {}
    cands = search_mod.generate_candidates(dag, alloc, ranked.vms, lib)
    for i, cand in enumerate(cands):
        gi = build_group_index(dag, alloc, cand.mapping, lib, ranked.policy)
        key = (tuple(p2(hi - lo) if hi > lo else 0
                     for lo, hi in gi.row_slices()), p2(len(gi.slots)))
        buckets.setdefault(key, []).append(i)
    return [len(v) for v in buckets.values()]


def max_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max()) if a.size else 0.0


def against_plain(reference, args, kw, kern, tol: float = SWEEP_TOL
                  ) -> tuple:
    """Run the plain version on the kernel call's own card tensors and hold
    the kernel's outputs ``kern`` against it field by field: (max abs error,
    all fields within ``tol`` abs + rel, the plain call's event time in
    ms)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain = reference(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    err = max((float((k - p).abs().max()) if k.numel() else 0.0
               for k, p in zip(kern, plain)), default=0.0)
    close = all(k.shape == p.shape and torch.allclose(
        k, p, rtol=tol, atol=tol) for k, p in zip(kern, plain))
    return err, close, start.elapsed_time(end)


# phase 3c: the hybrid_moe kernels at nemotron-3-nano-30b-a3b's widths: the
# grouped relu^2 experts (top-6 of 128 experts of 2688 x 1856) at a decode
# step's 64 tokens and at prefills of 192 and 512, and the SSD kernel with
# B/C in 8 groups (64 heads of 64, state 128)
MOE_SHAPE = dict(E=128, D=2688, F=1856, k=6)
MOE_TOKENS = (64, 192, 512)
MOE_TOLS = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def moe_inputs(gen, dev, n, E, D, F, k, dtype):
    """Token rows, each of n tokens sent to k distinct experts drawn from
    ``gen``, sorted by expert as the MoE hands them over."""
    x = torch.randn(n, D, generator=gen, device=dev)
    wu = torch.randn(E, D, F, generator=gen, device=dev) / D ** 0.5
    wd = torch.randn(E, F, D, generator=gen, device=dev) / F ** 0.5
    ids = torch.rand(n, E, generator=gen, device=dev).argsort(-1)[:, :k]
    ids = ids.reshape(-1)
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=E)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    scale = torch.rand(n * k, generator=gen, device=dev)[order].contiguous()
    args = (x.to(dtype), order // k, order, scale, offsets.to(torch.int32),
            wu.to(dtype), wd.to(dtype))
    return args, int((counts > 0).sum())


def hybrid_moe_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 3c: each kernel against its plain version (the grouped
    experts relative to the largest output, at ``MOE_TOLS``; SSD at the
    reference's tolerances), and the grouped experts' device time against
    the bytes of the experts hit."""
    from repro_torch.kernels.moe_grouped import kernel as moe_kernel
    from repro_torch.kernels.moe_grouped.ops import grouped_relu2
    from repro_torch.kernels.moe_grouped.ref import grouped_relu2 as plain
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference

    res = {"errors": {}, "ms": {}, "bound_ms": {}}
    E, D, F, k = (MOE_SHAPE[c] for c in "EDFk")
    cases = [(n, E, D, F, k, torch.bfloat16) for n in MOE_TOKENS]
    cases.append((37, 8, 64, 48, 2, torch.float32))
    for n, e, d, f, kk, dtype in cases:
        args, hit = moe_inputs(gen, dev, n, e, d, f, kk, dtype)
        before = moe_kernel.launch_count()
        out = grouped_relu2(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        err = float((out - want).abs().max() / want.abs().max())
        ok = (moe_kernel.launch_count() == before + 1
              and out.shape == want.shape and err <= MOE_TOLS[dtype])
        name = f"{n} tokens {str(dtype)[6:]}"
        res["errors"][name] = err
        line = (f"moe_grouped vs plain [{name}] top-{kk} of {e} experts of "
                f"{d} x {f}, {hit} hit: max_abs_err / max {err:.3g} (tol "
                f"{MOE_TOLS[dtype]:g})")
        if dtype == torch.bfloat16:
            ms, by = device_ms(lambda: grouped_relu2(*args))
            nbytes = hit * 2 * d * f * 2 + n * d * 2 + n * kk * d * 4
            bound_ms, bound_by = bound(4.0 * n * kk * d * f, nbytes)
            res["ms"][n], res["bound_ms"][n] = ms, bound_ms
            line += (f"; device ms per call (profiler, 20 calls) {ms:.6f} ("
                     + ", ".join(f"{a} {b:.6f}" for a, b in sorted(by.items()))
                     + f"), bound_ms {bound_ms:.6f} ({bound_by}), "
                     f"{100 * bound_ms / ms:.2f}% of it")
        print(line + (" ok" if ok else " MISMATCH"), flush=True)
        if not ok:
            fail(f"the grouped expert kernel disagrees with the plain "
                 f"version at {name}")
        del args, out, want
    for S, dtype, with_init in ((512, torch.bfloat16, False),
                                (300, torch.bfloat16, True),
                                (300, torch.float32, True)):
        H, P, N, G, Q = 64, 64, 128, 8, 128
        x = torch.randn((1, S, H, P), generator=gen, device=dev).to(dtype)
        dt = 0.01 + 0.19 * torch.rand((1, S, H), generator=gen, device=dev)
        A = -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev))
        Bm, Cm = (torch.randn((1, S, G, N), generator=gen,
                              device=dev).to(dtype) for _ in range(2))
        init = (torch.randn((1, H, P, N), generator=gen, device=dev)
                if with_init else None)
        y, fs = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q, init_state=init)
        torch.cuda.synchronize()
        y_ref, fs_ref = ssd_reference(x, dt, A, Bm, Cm, chunk=Q,
                                      init_state=init)
        tol = SSD_Y_TOLS[dtype]
        dy = (y.float() - y_ref.float()).abs()
        ds = (fs - fs_ref).abs()
        ok = (bool((dy <= tol + tol * y_ref.float().abs()).all())
              and bool((ds <= SSD_STATE_TOL
                        + SSD_STATE_TOL * fs_ref.abs()).all()))
        name = f"G=8 S={S} {str(dtype)[6:]} init_state={with_init}"
        res["errors"]["ssd " + name] = float(dy.max())
        print(f"ssd kernel vs plain [{name}] H={H} P={P} N={N} chunk={Q}: y "
              f"max_abs_err {float(dy.max()):.3g} (tol {tol:g} abs + rel), "
              f"state max_abs_err {float(ds.max()):.3g} (tol "
              f"{SSD_STATE_TOL:g}) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the SSD kernel disagrees with the plain version at {name}")
    torch.cuda.empty_cache()
    return res


# phase 3d: the split-KV decode-attention kernel at the cells' decode shapes:
# minicpm-2b's 16 slots x 36 heads of 64 over 4136 and 1544 positions, and
# nemotron-3-nano-30b-a3b's 64 slots x 32 query / 2 KV heads of 128 over
# 1544; every slot at the full length (the byte bound's case), then at
# lengths drawn uniformly below it
DECODE_SHAPES = {"minicpm-2b 16 x 4136": (16, 4136, 36, 36, 64),
                 "minicpm-2b 16 x 1544": (16, 1544, 36, 36, 64),
                 "nemotron-3-nano 64 x 1544": (64, 1544, 32, 2, 128)}
# (atol, rtol) of the kernel against the plain version by dtype: an output
# value at these lengths has a std of about 0.03 (randn logits spread the
# softmax over ~S/e keys), so bf16 is held to a tenth of that, about twice
# the widest error measured; fp32 to the card tests' 1e-5
DECODE_TOLS = {torch.bfloat16: (2e-3, 1e-2), torch.float32: (1e-5, 1e-5)}


def decode_attention_kernels(dev: torch.device, gen: torch.Generator) -> dict:
    """Phase 3d: the kernel against its plain version (``DECODE_TOLS``, in
    bf16 and, once a shape, in fp32), its device time (profiler; CUDA
    events beside it) against the bytes of the live cache, the plain
    version's time, and SDPA with a length mask as the yardstick only (the
    port never calls it)."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        reference_decode_attention

    F = torch.nn.functional
    res = {"errors": {}, "fp32_errors": {}, "ms": {}, "event_ms": {},
           "bound_ms": {}, "plain_ms": {}, "library_ms": {}}

    def agrees(out, want):
        atol, rtol = DECODE_TOLS[out.dtype]
        diff = (out.float() - want.float()).abs()
        return diff, (bool(torch.isfinite(out.float()).all()) and bool(
            (diff <= atol + rtol * want.float().abs()).all()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (B, S, H, K, hd) in DECODE_SHAPES.items():
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, K, hd), generator=gen, device=dev)
                .bfloat16() for _ in range(2))
        plan = da_kernel.split_plan(B, K, H // K, S, sms)
        drawn = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        for lengths, lens in (("full", torch.full((B,), S, device=dev)),
                              ("drawn", drawn)):
            case = f"{name} {lengths}"
            before = da_kernel.launch_count()
            out = decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            want = reference_decode_attention(q, k, v, lens)
            diff, close = agrees(out, want)
            ok = da_kernel.launch_count() == before + 1 and close
            res["errors"][case] = float(diff.max())
            live = int(lens.sum())
            nbytes = live * K * hd * 2 * 2 + 2 * q.numel() * 2
            flops = 4.0 * live * H * hd
            bound_ms = nbytes / HBM_BW * 1e3
            ms, by = device_ms(lambda: decode_attention(q, k, v, lens))
            ev = time_ms(lambda: decode_attention(q, k, v, lens))
            mask = (torch.arange(S, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            fns = {"plain": lambda: reference_decode_attention(q, k, v, lens),
                   "library": lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, attn_mask=mask, enable_gqa=K != H)}
            other = {n: device_ms(fn, iters=5, warmup=1)[0]
                     for n, fn in fns.items()}
            res["ms"][case], res["event_ms"][case] = ms, ev
            res["bound_ms"][case] = bound_ms
            res["plain_ms"][case] = other["plain"]
            res["library_ms"][case] = other["library"]
            print(f"decode_attn vs plain [{case}] B={B} S_max={S} H={H} K={K} "
                  f"hd={hd} bf16, {live} live keys, plan (gb, groups, "
                  f"nsplit, chunk) {plan}: max_abs_err {float(diff.max()):.3g}"
                  f" (tol {DECODE_TOLS[torch.bfloat16]} abs, rel); device "
                  f"ms per call (profiler, "
                  f"20 calls) {ms:.6f} ("
                  + ", ".join(f"{a} {b:.6f}" for a, b in sorted(by.items()))
                  + f"), event ms {ev:.6f}; bound_ms {bound_ms:.6f} (bytes: "
                  f"{nbytes} B; the FP32 FMAs {flops / PEAK_FP32 * 1e3:.6f} ms"
                  f"), {100 * bound_ms / ms:.2f}% of it; plain "
                  f"{other['plain']:.6f}, library (SDPA, a length mask) "
                  f"{other['library']:.6f}" + (" ok" if ok else " MISMATCH"),
                  flush=True)
            if not ok:
                fail(f"the decode-attention kernel disagrees with the plain "
                     f"version at {case}")
        del q, k, v, out, want, mask, qt, kt, vt, fns
        # the same shape once in fp32, at the drawn lengths: a boundary or
        # combine error of the size of one tile's keys shows far above 1e-5
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   for shape in ((B, 1, H, hd), (B, S, K, hd), (B, S, K, hd)))
        out = decode_attention(q, k, v, drawn)
        torch.cuda.synchronize()
        diff, ok = agrees(out, reference_decode_attention(q, k, v, drawn))
        res["fp32_errors"][name] = float(diff.max())
        print(f"decode_attn vs plain [{name} drawn] fp32: max_abs_err "
              f"{float(diff.max()):.3g} (tol {DECODE_TOLS[torch.float32]} "
              "abs, rel)" + (" ok" if ok else " MISMATCH"), flush=True)
        if not ok:
            fail(f"the decode-attention kernel disagrees with the plain "
                 f"version in fp32 at {name}")
        del q, k, v, out, diff
    torch.cuda.empty_cache()
    return res


def scheduler_phase(dev: torch.device):
    """Phase 7; returns the scheduler JSON and the sweep kernel's entry of
    the kernels line."""
    from repro_torch.core import (ALL_DAGS, ALLOCATORS, DataflowSimulator,
                                  SweepBatch, paper_library, plan,
                                  scan_kernel_cache_stats)
    from repro_torch.core import search as search_mod
    from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
    from repro_torch.kernels.sweep_scan.ref import (n_samples_of,
                                                    sweep_scan_reference)

    # the sweep kernel's registers and spills, from ptxas (built in phase 2):
    # its shared-memory instantiation, which the sweeps below run, and the
    # device-memory one
    ptxas = {fn: v for fn, v in ptxas_report(
        str(sweep_kernel.build()["ptxas"])).items() if "sweep" in fn}
    if sorted(ptxas) != ["sweep_wave_kernel<false>",
                         "sweep_wave_kernel<true>"]:
        fail(f"ptxas reports sweep kernel functions {sorted(ptxas)}, "
             "expected sweep_wave_kernel<false> and <true>")
    fn_name = "sweep_wave_kernel<false>"
    regs, spill_st, spill_ld = ptxas[fn_name]
    resources = {"function": fn_name, "registers": regs,
                 "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld,
                 "device_layout_registers_spills": ptxas[
                     "sweep_wave_kernel<true>"]}
    res_text = (f"{fn_name}: {regs} registers, spills {spill_st}/{spill_ld} "
                "B (ptxas)")

    lib = paper_library()
    sims = {}
    for name in sorted(ALL_DAGS):
        s = plan(ALL_DAGS[name](), 100.0, lib, allocator="mba", mapper="sam")
        sims[name] = DataflowSimulator(s.dag, s.allocation, s.mapping, lib)

    # one untimed sweep first, so that every timed one below is warm (the
    # process's first sweep carries its one-time costs)
    sims["linear"].sweep_raw(SWEEP_OMEGAS, **SWEEP_KW)
    # the main path: six sweeps on the kernel, counted
    raws, walls = {}, {}
    with recorded_calls(sweep_kernel, "sweep_scan_fwd") as calls:
        sweep_kernel.reset_launch_count()
        for name, sim in sims.items():    # each ends in a read of the result
            t0 = time.perf_counter()
            raws[name] = sim.sweep_raw(SWEEP_OMEGAS, **SWEEP_KW)
            walls[name] = (time.perf_counter() - t0) * 1e3
        sweep_launches = sweep_kernel.launch_count()
    if sweep_launches != len(sims):
        fail(f"sweep kernel launches {sweep_launches}, expected {len(sims)}")
    sweeps, worst = {}, 0.0
    for (name, sim), (args, kw, kern) in zip(sims.items(), calls):
        raw = raws[name]
        t0 = time.perf_counter()
        host = sim.sweep_raw(SWEEP_OMEGAS, engine="numpy", **SWEEP_KW)
        numpy_s = time.perf_counter() - t0
        # the main path's kernel outputs against the plain version on the
        # same card tensors
        err_plain, close_plain, plain_ms = against_plain(
            sweep_scan_reference, args, kw, kern)
        err_numpy = {f: max_err(getattr(raw, f), getattr(host, f))
                     for f in RAW_FIELDS}
        close_numpy = all(
            getattr(raw, f).shape == getattr(host, f).shape and np.allclose(
                getattr(raw, f), getattr(host, f), rtol=SWEEP_TOL,
                atol=SWEEP_TOL) for f in RAW_FIELDS)
        batch = sim._batch
        res_k = batch.results_from_raw([SWEEP_OMEGAS], raw)[0]
        res_n = batch.results_from_raw([SWEEP_OMEGAS], host)[0]
        stable_k = [r.stable for r in res_k]
        same_verdicts = stable_k == [r.stable for r in res_n]
        msr = {e: sim.max_stable_rate(engine=e) for e in ("scan", "numpy")}
        spec = batch.spec
        launch = launch_report(sweep_kernel, args, kw)
        chain = sweep_chain(args[6], args[5].cpu().numpy(),
                            args[3].cpu().numpy())
        sweeps[name] = {
            "T": spec.n_rows, "G": spec.n_groups, "S": len(spec.slots),
            "E": sum(len(e) for e in spec.in_edges),
            "max_abs_err_vs_numpy": max(err_numpy.values()),
            "max_abs_err_vs_plain": err_plain,
            "wall_ms": walls[name], "plain_event_ms": plain_ms,
            "numpy_host_ms": numpy_s * 1e3,
            "stable_rates": int(sum(stable_k)),
            "verdicts_equal": same_verdicts,
            "max_stable_rate": msr["scan"],
            "max_stable_rate_numpy": msr["numpy"],
            "chain_ops_per_tick": chain["wave"],
            "serial_chain_ops_per_tick": chain["serial"], **launch}
        worst = max(worst, err_plain)
        ok = close_plain and close_numpy and same_verdicts and \
            msr["scan"] == msr["numpy"]
        print(f"sweep [{name}] T={spec.n_rows} G={spec.n_groups} S="
              f"{len(spec.slots)}, 50 rates x {raw.steps} ticks in "
              f"{walls[name]:.3f} ms (numpy {numpy_s * 1e3:.3f}): kernel vs "
              f"numpy max_abs_err {max(err_numpy.values()):.3g}, vs plain on "
              f"the card {err_plain:.3g} (tol {SWEEP_TOL:g} abs "
              f"+ rel); stable {sum(stable_k)}/50, verdicts equal "
              f"{same_verdicts}; max_stable_rate {msr['scan']} (numpy "
              f"{msr['numpy']}) {'ok' if ok else 'MISMATCH'}; "
              f"{launch['warps_per_block']} warps/block, skew "
              f"{launch['skew']}, {launch['waves']} waves, "
              f"{launch['shared_bytes_per_block']} B shared/block, "
              f"{chain['wave']} chain ops/tick ({chain['serial']} row after "
              f"row), {res_text}", flush=True)
        if not ok:
            fail(f"the sweep kernel disagrees on {name}")
        if name == "grid":
            grid_args, grid_plain_ms = (args, kw), plain_ms
            grid_numpy_ms = numpy_s * 1e3

    # co-simulation of two DAGs on one pool (planned apart: shared slot ids)
    pair = SweepBatch([sims["linear"], sims["diamond"]])
    grids = [SWEEP_OMEGAS, 0.8 * SWEEP_OMEGAS]
    co_k = pair.sweep_raw(grids, **SWEEP_KW)
    co_n = pair.sweep_raw(grids, engine="numpy", **SWEEP_KW)
    co_err = max(max_err(getattr(co_k, f), getattr(co_n, f))
                 for f in RAW_FIELDS)
    shared = len(pair.spec.slots) < sum(len(s.gi.slots) for s in pair.sims)
    print(f"co-simulation [linear + diamond, {len(pair.spec.slots)} slots, "
          f"shared {shared}]: kernel vs numpy max_abs_err {co_err:.3g} "
          f"(tol {SWEEP_TOL:g})", flush=True)
    if co_err > SWEEP_TOL or not shared:
        fail("the co-simulated sweep disagrees with numpy")

    # the main path: plan(mapper="search"), counted per plan; its search's
    # ranking and every bucket's launch are recorded from that one run
    searches, search_launches = [], 0
    for name in SEARCH_DAGS:
        for omega in SEARCH_RATES:
            dag = ALL_DAGS[name]()
            with recorded_calls(search_mod, "search_mapping") as searched, \
                    recorded_calls(sweep_kernel, "sweep_scan_fwd") as calls:
                sweep_kernel.reset_launch_count()
                t0 = time.perf_counter()
                sched = plan(dag, omega, lib, mapper="search")
                plan_ms = (time.perf_counter() - t0) * 1e3
                launches = sweep_kernel.launch_count()
            search_launches += launches
            ranked = searched[0][2]
            # every bucket at its search shape (C candidates, padded groups)
            # against the plain version on the same card tensors
            bucket_errs, bucket_plain_ms, buckets_close = [], [], True
            for b_args, b_kw, b_out in calls:
                err, close, ms = against_plain(sweep_scan_reference, b_args,
                                               b_kw, b_out)
                bucket_errs.append(err)
                bucket_plain_ms.append(ms)
                buckets_close = buckets_close and close
                C, G, K = b_args[0].shape
                launch = launch_report(sweep_kernel, b_args, b_kw)
                real = int(b_args[5].sum())
                print(f"search bucket [{name} @ {omega:g}] C={C} G={G} ({real}"
                      f" real groups) K={K}: kernel vs plain on the card "
                      f"max_abs_err {err:.3g} (tol {SWEEP_TOL:g} abs + rel) "
                      f"{'ok' if close else 'MISMATCH'}; "
                      f"{launch['warps_per_block']} warps/block, skew "
                      f"{launch['skew']}, {launch['waves']} waves, "
                      f"{launch['shared_bytes_per_block']} B shared/block",
                      flush=True)
            worst = max([worst] + bucket_errs)
            t0 = time.perf_counter()
            host = search_mod.search_mapping(dag, omega, lib, engine="numpy")
            numpy_s = time.perf_counter() - t0
            alloc = ALLOCATORS["mba"](dag, omega, lib)
            want_buckets = pow2_buckets(search_mod, dag, alloc, lib, ranked)
            order = [c.name for c in ranked.candidates]
            entry = {
                "dag": name, "omega": omega, "winner": sched.search_winner,
                "winner_numpy": host.best.name,
                "rank_order_equal": order == [c.name for c in host.candidates],
                "same_mapping": sched.mapping.assignment
                == host.best.mapping.assignment,
                "candidates": len(order), "bucket_sizes": ranked.bucket_sizes,
                "launches": launches, "plan_wall_ms": plan_ms,
                "max_abs_err_vs_plain_per_bucket": bucket_errs,
                "numpy_host_ms": numpy_s * 1e3,
                "max_stable_rate": ranked.best.max_stable_rate}
            searches.append(entry)
            ok = (entry["winner"] == host.best.name == ranked.best.name
                  and entry["rank_order_equal"] and entry["same_mapping"]
                  and buckets_close and len(searched) == 1
                  and ranked.bucket_sizes == want_buckets
                  and launches == len(calls) == len(ranked.bucket_sizes))
            print(f"search [{name} @ {omega:g}]: plan in {plan_ms:.3f} ms "
                  f"(numpy engine's search {numpy_s * 1e3:.3f}), winner "
                  f"{sched.search_winner} (numpy {host.best.name}), "
                  f"{len(order)} candidates in "
                  f"buckets {ranked.bucket_sizes} (reference's "
                  f"{want_buckets}), {launches} launches, rank order equal "
                  f"{entry['rank_order_equal']} {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                fail(f"the kernel's search disagrees on {name} at {omega:g}")
            if (name, omega) == ("grid", 100.0):
                grid_search_calls, grid_search_numpy_ms = calls, numpy_s * 1e3
                grid_bucket_plain_ms = bucket_plain_ms

    # timing: the grid sweep, and the grid search's buckets
    args, kw = grid_args
    sweep_ms, sweep_ms_source = sweep_device_ms(
        lambda: sweep_kernel.sweep_scan_fwd(*args, **kw))
    sweep_event_ms = time_ms(lambda: sweep_kernel.sweep_scan_fwd(*args, **kw))
    structure, counts = args[6], args[5].cpu().numpy()
    flops, nbytes, column_ops = sweep_work(
        structure, args[0].cpu().numpy(), counts, kw["steps"], kw["s0"],
        n_samples_of(kw["steps"], kw["sample_every"]))
    grid_launch = launch_report(sweep_kernel, args, kw)
    grid_chain = sweep_chain(structure, counts, args[3].cpu().numpy())
    chain_ops = grid_chain["wave"] * grid_launch["waves"]
    sweep_bound_ms, sweep_bound_by = bound(flops, nbytes, PEAK_FP64)
    bucket_ms, bucket_event_ms = [], []
    bucket_plain_ms, bucket_chain = grid_bucket_plain_ms, []
    for b_args, b_kw, _ in grid_search_calls:
        ms, bucket_source = sweep_device_ms(
            lambda: sweep_kernel.sweep_scan_fwd(*b_args, **b_kw), iters=5)
        bucket_ms.append(ms)
        bucket_event_ms.append(time_ms(
            lambda: sweep_kernel.sweep_scan_fwd(*b_args, **b_kw), iters=5))
        bucket_chain.append(sweep_chain(b_args[6], b_args[5].cpu().numpy(),
                                        b_args[3].cpu().numpy())["wave"])
    timing = {
        "grid_sweep": {
            "C": 1, "K": len(SWEEP_OMEGAS), "steps": kw["steps"],
            "kernel_ms": sweep_ms, "kernel_ms_source": sweep_ms_source,
            "kernel_event_ms": sweep_event_ms,
            "plain_event_ms": grid_plain_ms, "numpy_host_ms": grid_numpy_ms,
            "bound_ms": sweep_bound_ms, "bound_by": sweep_bound_by,
            "flops": flops, "bytes": nbytes,
            "column_ops": column_ops,
            "kernel_ns_per_column_op": sweep_ms * 1e6 / column_ops,
            "chain_ops_per_tick": grid_chain["wave"],
            "serial_chain_ops_per_tick": grid_chain["serial"],
            "chain_ops": chain_ops,
            "kernel_ns_per_chain_op": sweep_ms * 1e6 / chain_ops,
            **grid_launch, **resources},
        "grid_search_100": {
            "buckets": [int(a[0].shape[0]) for a, _, _ in grid_search_calls],
            "K": int(grid_search_calls[0][0][0].shape[2]),
            "steps": grid_search_calls[0][1]["steps"],
            "kernel_ms_per_bucket": bucket_ms,
            "kernel_ms_source": bucket_source,
            "kernel_ms": sum(bucket_ms),
            "kernel_event_ms_per_bucket": bucket_event_ms,
            "chain_ops_per_tick_per_bucket": bucket_chain,
            "groups_per_bucket": [int(a[0].shape[1])
                                  for a, _, _ in grid_search_calls],
            "real_groups_per_bucket": [int(a[5].sum())
                                       for a, _, _ in grid_search_calls],
            "plain_event_ms_per_bucket": bucket_plain_ms,
            "plain_event_ms": sum(bucket_plain_ms),
            "numpy_host_ms": grid_search_numpy_ms}}
    print(f"sweep timing at the grid sweep (C=1, K=50, {kw['steps']} ticks), "
          f"ms: kernel {sweep_ms:.6f} ({sweep_ms_source}) / "
          f"{sweep_event_ms:.6f} (events); plain on the card "
          f"{grid_plain_ms:.6f} (events, 1 call); numpy engine "
          f"{grid_numpy_ms:.6f} (host); bound_ms {sweep_bound_ms:.6f} "
          f"({sweep_bound_by}; {flops:.4g} FP64 FLOP, {nbytes:.0f} B); "
          f"{column_ops:.0f} operations per column "
          f"({sweep_ms * 1e6 / column_ops:.3f} ns each); critical path "
          f"{grid_chain['wave']} dependent operations a wave ("
          f"{grid_chain['serial']} a tick row after row) x "
          f"{grid_launch['waves']} waves = {chain_ops}, "
          f"{sweep_ms * 1e6 / chain_ops:.3f} ns each", flush=True)
    print(f"sweep timing at the grid search at 100 t/s (buckets "
          f"{timing['grid_search_100']['buckets']}), ms: kernel "
          f"{sum(bucket_ms):.6f} ({bucket_source}, summed over buckets: "
          + " / ".join(f"{m:.6f}" for m in bucket_ms)
          + f"; events {sum(bucket_event_ms):.6f}); plain on the "
          f"card {sum(bucket_plain_ms):.6f} (events); numpy engine search "
          f"{grid_search_numpy_ms:.6f} (host, whole search)", flush=True)
    print(json.dumps({"scheduler": {
        "sweeps": sweeps, "sweep_launches": sweep_launches,
        "cosim": {"dags": ["linear", "diamond"],
                  "slots": len(pair.spec.slots),
                  "max_abs_err_vs_numpy": co_err},
        "searches": searches, "timing": timing,
        "cache": scan_kernel_cache_stats()}}), flush=True)
    return {
        "name": "sweep_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sweep_scan/csrc/sweep_scan.cu",
        "replaces": "src/repro/core/simulator.py:652",
        "launches": sweep_launches + search_launches,
        "launches_by_path": {"sweep_raw": sweep_launches,
                             "plan_search": search_launches},
        "max_abs_err": worst,
        "ms": sweep_ms,
        "kernel_ms": sweep_ms,
        "event_ms": sweep_event_ms,
        "plain_ms": grid_plain_ms,
        "plain_event_ms": grid_plain_ms,
        "bound_ms": sweep_bound_ms,
        "bound_by": sweep_bound_by,
        "library_ms": None,
    }


#: benchmarks/bench_fleet.py's fleet sizes and budgets (max_min, sam), two
#: fleets past its largest, and one whose state no longer fits a block's
#: shared memory (the kernel lays it out in device memory)
FLEETS = ((2, 16), (3, 32), (4, 64), (6, 64), (8, 96), (12, 128),
          (24, 256))
#: the kernel against its plain version on the same card tensors, in fleets
PLAIN_TOL = 1e-13
#: benchmarks/bench_online.py's 20-event day (BUDGET0, sam, STEP, MAX_RATE);
#: a "fail" kills the named DAG's last VM, resolved when the trace is built
ONLINE_OPTS = dict(budget_slots=44, mapper="sam", step=2.0, max_rate=2000.0)
ONLINE_TRACE = (
    ("arrive", ("lin-a", "linear", 100.0)),
    ("arrive", ("dia-a", "diamond", 150.0)),
    ("arrive", ("star-a", "star", 80.0)),
    ("rate", ("lin-a", 150.0)),
    ("arrive", ("tra-a", "traffic", 120.0)),
    ("grow", 6),
    ("arrive", ("lin-b", "linear", 60.0)),
    ("fail", "lin-a"),
    ("rate", ("star-a", 700.0)),
    ("rate", ("star-a", 720.0)),
    ("grow", 8),
    ("rate", ("star-a", 80.0)),
    ("arrive", ("star-b", "star", 70.0)),
    ("rate", ("lin-a", 151.0)),
    ("arrive", ("dia-b", "diamond", 100.0)),
    ("fail", "tra-a"),
    ("rate", ("tra-a", 60.0)),
    ("arrive", ("tra-b", "traffic", 90.0)),
    ("depart", "lin-b"),
    ("grow", 4),
)


def online_trace(core, lib):
    """ONLINE_TRACE as an EventTrace at t = 0, 1, ...: each VM failure is
    resolved to the DAG's last VM by a dry run without co-simulation
    (planning is deterministic, so a fresh controller meets the same
    ids)."""
    dry = core.FleetController(lib, **ONLINE_OPTS)
    events = []
    for t, (kind, payload) in enumerate(ONLINE_TRACE):
        if kind == "arrive":
            name, dag, ceiling = payload
            ev = core.DagArrive(name, core.ALL_DAGS[dag](), max_rate=ceiling)
        elif kind == "depart":
            ev = core.DagDepart(payload)
        elif kind == "rate":
            ev = core.RateChange(*payload)
        elif kind == "grow":
            ev = core.VmAdd(payload)
        else:
            ev = core.VmFail(dry.entry(payload).schedule.vms[-1].id)
        dry.apply(ev)
        events.append((float(t), ev))
    return core.EventTrace(events)


def close_fields(a, b, tol) -> bool:
    return a.shape == b.shape and np.allclose(a, b, rtol=tol, atol=tol)


def fleet_phase() -> dict:
    """Phase 8; returns what the sweep kernel's entry of the kernels line
    gains."""
    import repro_torch.core as core
    from repro_torch.core import online as online_mod
    from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
    from repro_torch.kernels.sweep_scan.ref import (n_samples_of,
                                                    sweep_scan_reference)

    lib = core.paper_library()
    plans = {}
    for size, budget in FLEETS:
        names = [f"{n}{i}" for i, n in enumerate(
            itertools.islice(itertools.cycle(core.ALL_DAGS), size))]
        plans[size] = core.plan_fleet(
            {n: core.ALL_DAGS[n.rstrip("0123456789")]() for n in names}, lib,
            budget_slots=budget, objective="max_min", mapper="sam")
    # one untimed co-simulation first, so that every timed one is warm
    core.simulate_fleet(plans[FLEETS[0][0]], lib)

    fleets, launches_total, worst_plain = [], 0, 0.0
    for size, budget in FLEETS:
        fp = plans[size]
        # the main path: one co-simulation of the whole fleet, counted
        with recorded_calls(core.SweepBatch, "sweep_raw") as raws, \
                recorded_calls(sweep_kernel, "sweep_scan_fwd") as calls:
            sweep_kernel.reset_launch_count()
            t0 = time.perf_counter()
            rep = core.simulate_fleet(fp, lib)
            kernel_ms = (time.perf_counter() - t0) * 1e3
            launches = sweep_kernel.launch_count()
        launches_total += launches
        with recorded_calls(core.SweepBatch, "sweep_raw") as host_raws:
            t0 = time.perf_counter()
            rep_n = core.simulate_fleet(fp, lib, engine="numpy")
            numpy_ms = (time.perf_counter() - t0) * 1e3
        if launches != 1 or len(calls) != 1 or len(raws) != 1:
            fail(f"fleet of {size}: {launches} sweep launches, expected 1")
        (args, kw, kern), raw, host = calls[0], raws[0][2], host_raws[0][2]
        err_numpy = max(max_err(getattr(raw, f), getattr(host, f))
                        for f in RAW_FIELDS)
        ok_numpy = all(close_fields(getattr(raw, f), getattr(host, f),
                                    SWEEP_TOL) for f in RAW_FIELDS)
        for name, e in rep.entries.items():
            h = rep_n.entries[name]
            ok_numpy &= (e.actual_max_stable == h.actual_max_stable
                         and e.predicted_max_rate == h.predicted_max_rate
                         and [r.stable for r in e.results]
                         == [r.stable for r in h.results])
        for a, b in ((rep.slot_busy, rep_n.slot_busy),
                     (rep.vm_cpu_actual, rep_n.vm_cpu_actual),
                     (rep.vm_mem_actual, rep_n.vm_mem_actual)):
            keys = sorted(b, key=str)
            ok_numpy &= sorted(a, key=str) == keys and close_fields(
                np.array([a[k] for k in keys]),
                np.array([b[k] for k in keys]), SWEEP_TOL)
        err_plain, ok_plain, plain_ms = against_plain(
            sweep_scan_reference, args, kw, kern, PLAIN_TOL)
        worst_plain = max(worst_plain, err_plain)
        launch = launch_report(sweep_kernel, args, kw)
        dev_ms, dev_source = sweep_device_ms(
            lambda: sweep_kernel.sweep_scan_fwd(*args, **kw), iters=5)
        structure, counts = args[6], args[5].cpu().numpy()
        flops, nbytes, _ = sweep_work(
            structure, args[0].cpu().numpy(), counts, kw["steps"], kw["s0"],
            n_samples_of(kw["steps"], kw["sample_every"]))
        bound_ms, bound_by = bound(flops, nbytes, PEAK_FP64)
        spec = raws[0][0][0].spec
        entry = {
            "dags": size, "budget": budget, "T": spec.n_rows,
            "G": spec.n_groups, "S": len(spec.slots),
            "L": int(counts.sum(axis=1).max()), "K": int(args[0].shape[2]),
            "steps": kw["steps"], "launches": launches,
            "kernel_wall_ms": kernel_ms, "numpy_wall_ms": numpy_ms,
            "kernel_device_ms": dev_ms, "kernel_ms_source": dev_source,
            "plain_event_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err_vs_numpy": err_numpy,
            "max_abs_err_vs_plain": err_plain, **launch}
        ok = ok_numpy and ok_plain
        fleets.append(entry)
        print(f"fleet [{size} DAGs, {budget} slots] T={spec.n_rows} "
              f"G={spec.n_groups} S={len(spec.slots)} L={entry['L']} "
              f"K={entry['K']}: {launches} launch; {launch['warps_per_block']}"
              f" warps/block, skew {launch['skew']}, {launch['lag_rows']} "
              f"lag rows, {launch['waves']} waves, "
              f"{launch['layout_bytes_per_block']} B/block in "
              f"{launch['placement']} memory; simulate_fleet wall ms kernel "
              f"{kernel_ms:.3f} (numpy {numpy_ms:.3f}), kernel ms "
              f"{dev_ms:.6f} ({dev_source}; bound {bound_ms:.6f}, "
              f"{bound_by}); kernel vs "
              f"numpy max_abs_err {err_numpy:.3g} (tol {SWEEP_TOL:g}), vs "
              f"plain on the card {err_plain:.3g} (tol {PLAIN_TOL:g} abs + "
              f"rel) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"fleet co-simulation of {size} DAGs disagrees")

    # the controller: the 20-event day replayed with co-simulation
    replays, walls, sims_run = {}, {}, {}
    for engine in ("scan", "numpy"):
        ctl = core.FleetController(lib, **ONLINE_OPTS)
        trace = online_trace(core, lib)
        with recorded_calls(online_mod, "simulate_fleet") as simulated:
            sweep_kernel.reset_launch_count()
            t0 = time.perf_counter()
            log = ctl.replay(trace, simulate=True, engine=engine)
            walls[engine] = (time.perf_counter() - t0) * 1e3
            launches = sweep_kernel.launch_count()
        replays[engine] = (ctl, log, launches)
        sims_run[engine] = len(simulated)
    (ctl, log, replay_launches), (_, log_n, numpy_launches) = \
        replays["scan"], replays["numpy"]
    same = ([(r.rates, r.stable) for r in log.records]
            == [(r.rates, r.stable) for r in log_n.records])
    ok = (same and len(log) == len(ONLINE_TRACE) and numpy_launches == 0
          and replay_launches == sims_run["scan"] > 0)
    sweep_kernel.reset_launch_count()
    proved = ctl.cosimulate(prove=True)
    prove_launches = sweep_kernel.launch_count()
    ok &= prove_launches == (0 if proved.engine == "proved" else 1)
    stable_n = sum(sum(r.stable.values()) for r in log.records)
    controller = {
        "events": len(log), "dags_at_end": len(ctl.dag_names),
        "launches": replay_launches, "cosimulations": sims_run["scan"],
        "verdicts_and_rates_equal_numpy": same,
        "stable_verdicts": stable_n,
        "kernel_replay_wall_ms": walls["scan"],
        "numpy_replay_wall_ms": walls["numpy"],
        "prove": {"engine": proved.engine, "launches": prove_launches,
                  "proved": {n: e.proved for n, e in proved.entries.items()}}}
    print(f"controller [bench_online's {len(log)} events, "
          f"{len(ctl.dag_names)} DAGs at the end]: replay(simulate=True) "
          f"{walls['scan']:.3f} ms on the kernel ({replay_launches} launches "
          f"for {sims_run['scan']} co-simulations), {walls['numpy']:.3f} ms "
          f"on numpy; per-event rates and stable verdicts equal {same}; "
          f"cosimulate(prove=True): engine {proved.engine}, "
          f"{prove_launches} launches, proved {controller['prove']['proved']}"
          f" {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the controller replay on the kernel disagrees with numpy")
    print(json.dumps({"fleet": {"fleets": fleets, "controller": controller}}),
          flush=True)
    return {"launches": launches_total + replay_launches + prove_launches,
            "fleet_launches": launches_total,
            "controller_launches": replay_launches + prove_launches,
            "fleet_max_abs_err_vs_plain": worst_plain,
            "fleet_launch_shape": {k: fleets[-1][k] for k in (
                "dags", "warps_per_block", "skew", "lag_rows",
                "layout_bytes_per_block", "placement", "waves")}}



#: benchmarks/bench_chaos.py's day: its slot budget, frames an event, batch
#: and 20-event trace (arrivals, a burst, departures; 4 tenants at most)
CHAOS_BUDGET, CHAOS_FRAMES, CHAOS_BATCH = 40, 12, 16
CHAOS_TRACE = (
    ("arrive", ("lin-a", "linear", 100.0)),
    ("arrive", ("dia-a", "diamond", 80.0)),
    ("rate", ("lin-a", 150.0)),
    ("arrive", ("star-a", "star", 60.0)),
    ("rate", ("dia-a", 120.0)),
    ("rate", ("star-a", 90.0)),
    ("arrive", ("dia-b", "diamond", 60.0)),
    ("rate", ("lin-a", 200.0)),
    ("rate", ("dia-a", 150.0)),
    ("rate", ("star-a", 120.0)),
    ("rate", ("dia-b", 90.0)),
    ("rate", ("lin-a", 160.0)),
    ("depart", "star-a"),
    ("rate", ("dia-a", 100.0)),
    ("arrive", ("lin-b", "linear", 70.0)),
    ("rate", ("dia-b", 60.0)),
    ("rate", ("lin-a", 100.0)),
    ("rate", ("lin-b", 50.0)),
    ("rate", ("dia-a", 80.0)),
    ("depart", "dia-b"),
)
#: the operator kernels, each with the reference body it replaces
STREAM_KERNELS = {
    "parse_xml": "src/repro/runtime/operators.py:24",
    "viete_pi": "src/repro/runtime/operators.py:37",
    "rolling_digest": "src/repro/runtime/operators.py:52",
    "external_service": "src/repro/runtime/operators.py:60",
}
#: part sizes held against the plain versions, bit for bit; payloads of
#: 256 bytes (§8.3); and the size of the special parts (negative values,
#: a service key whose chain wraps at 1000)
STREAM_PARTS, STREAM_LEN, STREAM_SPECIAL = (1, 7, 16, 32, 33, 1024), 256, 16
#: the main path's part: one frame of the stream's batch
STREAM_BATCH = 16
#: parse_xml on bytes 0-255: rows, and (label, row length, byte offset)
#: of each case, with the path the payload takes
PARSE_BYTES_ROWS = 1024
PARSE_BYTES_CASES = (("L=256, 16-byte aligned", 256, 0, "vector"),
                     ("L=255", 255, 0, "byte"),
                     ("L=256 at an odd byte offset", 256, 1, "byte"))
#: digest parts past one block's reach (16384): one level of tile totals in
#: device memory, and two
DIGEST_LONG_PARTS = (200_000, 300_000)
#: calls timed for each piece of a launch's host path
LAUNCH_PATH_CALLS = 10_000
#: dependent steps the chain probe times for each kind
PROBE_STEPS = 1024
#: chain_probe.cu's step kinds, in its enum's order
PROBE_KINDS = ("service_step", "service_first_step", "service_fast_step",
               "viete_step", "fadd", "digest_step", "shfl_iadd", "iadd",
               "fdiv", "shfl", "tag_word", "load")
#: the WallClock stream: each seed DAG planned at and driven at this rate
STREAM_RATE, STREAM_FRAMES = 100.0, 200
#: diamond's ladder of planned and offered rates (t/s)
STREAM_LADDER = (100.0, 1000.0, 5000.0, 20000.0)
#: tests/test_obs.py's mis-profiled fleet: budget, DAG rate, policy
AUTO_RECAL = dict(budget=24, rate=4000.0, threshold=0.15, cooldown=2)
STREAM_REPORT_FIELDS = (
    "omega", "frames", "tuples", "wall_seconds", "throughput", "mean_latency",
    "p99_latency", "latency_slope", "stable", "stable_reason", "frames_shed",
    "frames_timed_out", "frames_failed", "retries", "tuples_lost",
    "escalated_vms")


def chaos_events(core, trace=CHAOS_TRACE):
    """bench_chaos._events: the trace as the port's events."""
    for kind, payload in trace:
        if kind == "arrive":
            name, dag, demand = payload
            yield core.DagArrive(name, core.ALL_DAGS[dag](), max_rate=demand)
        elif kind == "rate":
            yield core.RateChange(*payload)
        else:
            yield core.DagDepart(payload)


def chaos_fault_plan(rt):
    """bench_chaos._fault_plan: the seeded mix (seed 11: 3 operator errors,
    3 slowdowns, 2 drops on lin-a, dia-a, dia-b) plus the correlated crash
    of lin-a's first two VMs mid-burst."""
    seeded = rt.FaultPlan.from_seed(
        11, dags=["lin-a", "dia-a", "dia-b"], tasks=["b", "c"],
        horizon_frames=CHAOS_FRAMES * 10, operator_errors=3, slowdowns=3,
        drops=2)
    crash = CHAOS_FRAMES * 7 + 4
    return rt.FaultPlan(faults=seeded.faults + tuple(
        rt.Fault(rt.FaultKind.VM_CRASH, frame=crash, dag="lin-a", vm_index=i)
        for i in (0, 1)), seed=seeded.seed)


def scaled_library(core, lib, factor: float, scale_static: bool = True):
    """Every rate of ``lib`` times ``factor``: bench_chaos._doubled, or,
    with ``scale_static`` off, tests/test_obs.py's _scaled."""
    out = core.ModelLibrary()
    for kind in lib.kinds():
        m = lib[kind]
        f = factor if (scale_static or not m.static) else 1.0
        out.add(core.PerfModel(kind, [core.ModelPoint(p.tau, p.rate * f,
                                                      p.cpu, p.mem)
                                      for p in m.points], static=m.static))
    return out


def slot_key(s) -> tuple:
    return (s.vm, s.slot)


def stream_report(rep) -> tuple:
    """Every field of an ExecutionReport; the device frame counts by value
    (their keys name the device)."""
    return tuple(getattr(rep, f) for f in STREAM_REPORT_FIELDS) + (
        tuple(sorted(rep.device_frame_counts.values())),)


def enact_record(rec) -> dict:
    """What two enactments of one day must agree on, wall times aside."""
    def rebind(i):
        return ([slot_key(s) for s in i.kept_slots],
                [slot_key(s) for s in i.restarted_slots],
                sorted((slot_key(a), slot_key(b))
                       for a, b in i.transplanted.items()),
                i.reused_ops, i.fresh_ops)

    def ctl(r):
        return (r.time, r.kind, r.rates, r.changed, r.threads_migrated,
                r.threads_total, r.slots_moved, r.stable, r.drift_alerts,
                r.recalibrated)
    return dict(
        controller=ctl(rec.controller), spawned=rec.spawned,
        retired=rec.retired, untouched=rec.untouched,
        rebound={n: rebind(i) for n, i in rec.rebound.items()},
        reports={n: stream_report(r) for n, r in rec.reports.items()},
        escalations=rec.escalations,
        repairs=[ctl(r) for r in rec.repairs],
        recovery={n: stream_report(r)
                  for n, r in rec.recovery_reports.items()},
        drift_magnitude=rec.drift_magnitude, drift_alerts=rec.drift_alerts,
        recalibration=(None if rec.recalibration is None
                       else ctl(rec.recalibration)))


def recording_fleet(rt, *args, **kw):
    """A LiveFleet that keeps every executor it spawns (retired ones too),
    so that a run's operator calls can be summed."""
    fleet = rt.LiveFleet(*args, **kw)
    spawned, spawn = [], fleet._spawn

    def record(name, sched):
        ex = spawn(name, sched)
        spawned.append(ex)
        return ex
    fleet._spawn = record
    return fleet, spawned


def kernel_calls(operators, executors) -> dict:
    """Operator calls of the four kernels' kinds, by kernel."""
    calls = dict.fromkeys(STREAM_KERNELS, 0)
    for ex in executors:
        for kind, n in ex.invocations.items():
            if kind in operators.KERNEL_OF:
                calls[operators.KERNEL_OF[kind]] += n
    return calls


def build_chain_probe() -> dict:
    """Build (if needed) and load ``chain_probe.cu``; its record's
    ``bound`` holds ``probe`` and ``empty``, their entry points."""
    import ctypes
    from repro_torch.kernels.nvcc import build_library
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    P, I = ctypes.c_void_p, ctypes.c_int
    rec = build_library(so_kernel.CSRC.parent / "chain_probe.cu",
                        "repro_chain_probe",
                        [I, I, ctypes.c_float, P, P, P, I, P])
    empty = rec["lib"].repro_stream_empty
    empty.restype, empty.argtypes = I, [I, P]
    rec["bound"] = {"probe": rec["fn"], "empty": empty}
    return rec


def stream_probe(dev: torch.device) -> dict:
    """Cycles per dependent step of each of ``chain_probe.cu``'s kinds (the
    least of three runs of PROBE_STEPS steps), an empty kernel's device ms
    and the SM clock nvidia-smi reports."""
    bound = build_chain_probe()["bound"]
    index = dev.index or 0
    cycles_t = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    zeros = torch.zeros(1, dtype=torch.int32, device=dev)
    cycles = {}
    for which, kind in enumerate(PROBE_KINDS):
        runs = []
        for _ in range(3):
            err = bound["probe"](which, PROBE_STEPS, 1.5, cycles_t.data_ptr(),
                                 sink.data_ptr(), zeros.data_ptr(), index,
                                 torch.cuda.current_stream(dev).cuda_stream)
            if err:
                fail(f"chain probe {kind}: cudaError_t {err}")
            torch.cuda.synchronize()
            runs.append(int(cycles_t.item()) / PROBE_STEPS)
        cycles[kind] = min(runs)

    def empty():
        err = bound["empty"](index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            fail(f"empty kernel: cudaError_t {err}")
    empty_ms, _ = device_ms(empty, iters=50, required=False)
    source = "device (profiler)"
    if empty_ms is None:
        empty_ms, source = time_ms(empty, iters=50), "events"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    sm_now, sm_max = (float(x) for x in smi[0].split(","))
    print(f"chain probe [{PROBE_STEPS} dependent steps, one warp, clock64, "
          f"least of 3]: cycles a step "
          + ", ".join(f"{k} {v:.2f}" for k, v in cycles.items())
          + f"; empty kernel {empty_ms:.7f} ms ({source}, 50 calls); SM "
          f"clock {sm_now:.0f} MHz now, {sm_max:.0f} MHz max (the floors use "
          f"the max)", flush=True)
    return {"cycles": cycles, "empty_ms": empty_ms, "empty_ms_source": source,
            "clock_hz": sm_max * 1e6, "clock_sm_mhz_now": sm_now}


def stream_chain(name: str, B: int) -> dict:
    """The dependent steps on a stream kernel's critical path, by
    ``chain_probe.cu`` kind, as stream_ops.cu runs them (the first read of
    the part an L2 hit; the stores, the barriers and the loop bookkeeping
    not included), at rows of STREAM_LEN bytes; None where the call is
    more than one kernel."""
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    from repro_torch.kernels.stream_ops.ref import (PI_ITERATIONS, SCAN_TILE,
                                                    SERVICE_WORK, SUM_WINDOW)
    if name == "parse_xml":               # the vector path: a lane's chunk
        lanes = so_kernel.parse_xml_lanes(0, STREAM_LEN)
        return {"load": 1,                # the lane's 16 bytes
                "shfl": 1,                # the next lane's first word
                "tag_word": 1,            # a word's tags and byte sum
                "iadd": 3,                # four words' sums into the lane's
                "shfl_iadd": lanes.bit_length() - 1}   # tags and sum, side by side
    if name == "viete_pi":                # sqrt(2), 14 steps, 2 / prod
        return {"viete_step": PI_ITERATIONS, "fdiv": 1}
    if name == "external_service":        # a lane's windows, then the chain
        adds, n = 0, B                    # (its path for keys that do not
        while n > SUM_WINDOW:             # wrap: the seeded parts')
            windows = -(-n // SUM_WINDOW)
            adds += -(-windows // 32) * SUM_WINDOW
            n = windows
        return {"load": 1, "fadd": adds + n, "service_first_step": 1,
                "service_fast_step": SERVICE_WORK - 1}
    if B > so_kernel.digest_reach():
        return None
    if B <= SCAN_TILE:                    # lane B - 1's own prefix, its %
        return {"load": 1, "shfl": 1, "fadd": B - 1, "digest_step": 1}
    lens = [B]                            # one block: the levels down, the
    while lens[-1] > SCAN_TILE:           # top alone, the offsets up
        lens.append(-(-lens[-1] // SCAN_TILE))
    passes = -(-lens[1] // 64)            # level 0's tiles a lane group
    down = passes * SCAN_TILE + SCAN_TILE * (len(lens) - 2)
    return {"load": passes, "shfl": passes + len(lens) - 1,
            "fadd": down + lens[-1] + len(lens) - 2,
            "digest_step": passes}


def launch_path_split(dev: torch.device) -> dict:
    """ns a call of each piece of a stream kernel's host path at a frame's
    part, over LAUNCH_PATH_CALLS calls each on the host clock, beside the
    alternatives the wrappers do without."""
    import threading
    from repro_torch.kernels.nvcc import check_operand
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    value = torch.rand(STREAM_BATCH, device=dev)
    payload = torch.randint(32, 127, (STREAM_BATCH, STREAM_LEN),
                            dtype=torch.uint8, device=dev)
    out = torch.empty_like(value)
    bound = so_kernel.build()["bound"]
    index = dev.index or 0
    raw = bound["stream"]
    lock, counted = threading.Lock(), {"n": 0}

    def count():
        with lock:
            counted["n"] += 1

    def launch():
        bound["external_service"](value.data_ptr(), STREAM_BATCH, 64,
                                  out.data_ptr(), index, raw(index))
    pieces = {
        "external_service_fwd whole": lambda: so_kernel.external_service_fwd(
            value),
        "viete_pi_fwd whole": lambda: so_kernel.viete_pi_fwd(value),
        "parse_xml_fwd whole": lambda: so_kernel.parse_xml_fwd(payload),
        "ctypes call (the launch)": launch,
        "stream: raw getter": lambda: raw(index),
        "stream: torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "entry: dict read": lambda: so_kernel._LIB.get("bound"),
        "entry: build() under the lock": so_kernel.build,
        "count: lock and add": count,
        "checks: by device index": lambda: so_kernel._operand(
            "v", value, (torch.float32,), 1),
        "checks: check_operand vs a torch.device": lambda: check_operand(
            "v", value, torch.float32, dev, align=4),
        "output: empty_like": lambda: torch.empty_like(value),
        "output: empty(device=dev)": lambda: torch.empty(
            (STREAM_BATCH,), dtype=torch.float32, device=dev),
        "parse_xml outputs: one (2, B) and its rows": lambda: payload.new_empty(
            (2, STREAM_BATCH), dtype=torch.int32).unbind(),
        "parse_xml outputs: two (B,)": lambda: (
            payload.new_empty((STREAM_BATCH,), dtype=torch.int32),
            payload.new_empty((STREAM_BATCH,), dtype=torch.int32)),
    }
    ns = {}
    for name, fn in pieces.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(LAUNCH_PATH_CALLS):
            fn()
        ns[name] = (time.perf_counter_ns() - t0) / LAUNCH_PATH_CALLS
        torch.cuda.synchronize()
    print(f"stream launch path [B={STREAM_BATCH}, ns a call, "
          f"{LAUNCH_PATH_CALLS} calls each, host clock]: "
          + "; ".join(f"{k} {v:.0f}" for k, v in ns.items()), flush=True)
    return ns


def parse_xml_paths(dev: torch.device) -> float:
    """parse_xml on seeded bytes 0-255 (a tenth '<', a tenth '/', one row
    of 255s) through each of its kernel's paths, against the plain version
    to 0, with the launches each path counted; its checksums' digest too.
    Returns the largest error."""
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    from repro_torch.kernels.stream_ops import ref as so_ref
    so_kernel.reset_launch_count()
    worst, want_paths = 0.0, dict.fromkeys(so_kernel.PARSE_XML_PATHS, 0)
    for label, L, offset, path in PARSE_BYTES_CASES:
        rng = np.random.default_rng(L + offset)
        raw = rng.integers(0, 256, size=PARSE_BYTES_ROWS * L + offset,
                           dtype=np.uint8)
        marks = rng.random(raw.shape)
        raw[marks < 0.1] = ord("<")
        raw[(marks >= 0.1) & (marks < 0.2)] = ord("/")
        raw[offset:offset + L] = 255
        payload = torch.from_numpy(raw).to(dev)[offset:].view(
            PARSE_BYTES_ROWS, L)
        tags, checksum = so_kernel.parse_xml_fwd(payload)
        digest = so_kernel.rolling_digest_fwd(checksum)
        torch.cuda.synchronize()
        ref_tags, ref_checksum = so_ref.parse_xml_reference(payload)
        ok = (torch.equal(tags, ref_tags) and torch.equal(checksum, ref_checksum)
              and torch.equal(digest,
                              so_ref.rolling_digest_reference(ref_checksum)))
        err = float(max((tags - ref_tags).abs().max(),
                        (checksum - ref_checksum).abs().max()))
        worst = max(worst, err)
        want_paths[path] += 1
        print(f"stream parse_xml vs plain [bytes 0-255, {PARSE_BYTES_ROWS} "
              f"rows, {label}, {path} path, address % 16 = "
              f"{payload.data_ptr() % 16}]: tags {int(tags.sum())}, checksum "
              f"max {int(checksum.max())}; tags, checksum and their digest "
              f"{'equal' if ok else 'DIFFER'} (max_abs_err {err:.3g}, "
              f"tolerance 0) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"parse_xml disagrees with its plain version on bytes 0-255 "
                 f"({label})")
    paths = so_kernel.parse_xml_path_count()
    print(f"stream parse_xml paths [the cases above]: launches {paths}, "
          f"expected {want_paths} {'ok' if paths == want_paths else 'MISMATCH'}",
          flush=True)
    if paths != want_paths:
        fail("parse_xml took another path than its payloads allow")
    return worst


def long_digests(dev: torch.device) -> float:
    """The digest past one block's reach (DIGEST_LONG_PARTS) on the float,
    checksum and negated-checksum columns of SyntheticSource's draw,
    against the plain version to 0.  Returns the largest error."""
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    from repro_torch.kernels.stream_ops import ref as so_ref
    worst = 0.0
    for B in DIGEST_LONG_PARTS:
        rng = np.random.default_rng(B)
        payload = torch.from_numpy(rng.integers(
            32, 127, size=(B, STREAM_LEN), dtype=np.uint8)).to(dev)
        value = torch.from_numpy(rng.random(B, dtype=np.float32)).to(dev)
        _, checksum = so_kernel.parse_xml_fwd(payload)
        parts, ok = [], True
        for label, x in (("float", value), ("checksum", checksum),
                         ("negated checksum", -checksum)):
            so_kernel.reset_launch_count()
            got = so_kernel.rolling_digest_fwd(x)
            launches = so_kernel.launch_count("rolling_digest")
            torch.cuda.synchronize()
            want = so_ref.rolling_digest_reference(x)
            same = got.shape == want.shape and torch.equal(got, want)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            ok &= same and launches == 1
            parts.append(f"{label} {'equal' if same else 'DIFFER'} "
                         f"(max_abs_err {err:.3g}, {launches} launch)")
        scratch = so_kernel.digest_scratch_floats(B)
        print(f"stream digest vs plain [B={B}, past one block's "
              f"{so_kernel.digest_reach()}: {scratch} floats of tile totals in "
              f"device memory]: " + "; ".join(parts)
              + f" (tolerance 0) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"the digest disagrees with its plain version at B={B}")
    return worst


def stream_kernel_phase(dev: torch.device) -> tuple:
    """Phase 9a: the four operator kernels against their plain versions on
    the card, to 0, then timed beside their bounds, latency floors and the
    host's launch path.  Returns each kernel's largest error and the
    timings."""
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    from repro_torch.kernels.stream_ops import ref as so_ref

    worst = dict.fromkeys(STREAM_KERNELS, 0.0)
    special = {"seeded": lambda v: v,
               "values * 1000 - 700": lambda v: v * 1000.0 - 700.0,
               "all 61.0, a key whose chain wraps": lambda v:
                   torch.full_like(v, 61.0)}
    for B, kind in (*((b, "seeded") for b in STREAM_PARTS),
                    *((STREAM_SPECIAL, k) for k in list(special)[1:])):
        rng = np.random.default_rng(B)                 # SyntheticSource's draw
        payload = torch.from_numpy(rng.integers(
            32, 127, size=(B, STREAM_LEN), dtype=np.uint8)).to(dev)
        value = special[kind](torch.from_numpy(
            rng.random(B, dtype=np.float32)).to(dev))
        tags, checksum = so_kernel.parse_xml_fwd(payload)
        got = {"viete_pi": so_kernel.viete_pi_fwd(value),
               "rolling_digest": so_kernel.rolling_digest_fwd(value),
               "rolling_digest_int": so_kernel.rolling_digest_fwd(checksum),
               "rolling_digest_negint":
                   so_kernel.rolling_digest_fwd(-checksum),
               "external_service": so_kernel.external_service_fwd(value)}
        torch.cuda.synchronize()
        ref_tags, ref_checksum = so_ref.parse_xml_reference(payload)
        want = {"viete_pi": so_ref.viete_pi_reference(B, dev),
                "rolling_digest": so_ref.rolling_digest_reference(value),
                "rolling_digest_int":
                    so_ref.rolling_digest_reference(checksum),
                "rolling_digest_negint":
                    so_ref.rolling_digest_reference(-checksum),
                "external_service":
                    so_ref.external_service_reference(value)}
        ok = torch.equal(tags, ref_tags) and torch.equal(checksum,
                                                         ref_checksum)
        parts = [f"parse_xml tags+checksum {'equal' if ok else 'DIFFER'} "
                 f"(tags {int(tags.sum())}, checksum max "
                 f"{int(checksum.max())})"]
        for name, g in got.items():
            w = want[name]
            same = g.shape == w.shape and torch.equal(g, w)
            err = float((g - w).abs().max())
            ok &= same
            kern = next(k for k in STREAM_KERNELS if name.startswith(k))
            worst[kern] = max(worst[kern], err)
            parts.append(f"{name} {'equal' if same else 'DIFFER'} "
                         f"(max_abs_err {err:.3g})")
        label = f"B={B}" + ("" if kind == "seeded" else f", {kind}")
        print(f"stream kernel vs plain [{label}, L={STREAM_LEN}]: "
              + "; ".join(parts) + f" (tolerance 0) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"a stream operator kernel disagrees with its plain version "
                 f"at {label}")
    worst["parse_xml"] = max(worst["parse_xml"], parse_xml_paths(dev))
    worst["rolling_digest"] = max(worst["rolling_digest"],
                                  long_digests(dev))

    # what binds them: the roofline bound beside a latency floor (the
    # chain's dependent steps at their measured cycles, at the SM clock,
    # after an empty kernel's device time or the first read, the larger),
    # and the host's launch path
    probe = stream_probe(dev)
    timing = {}
    for B, names in ((STREAM_BATCH, STREAM_KERNELS),
                     (STREAM_PARTS[-1], STREAM_KERNELS),
                     (DIGEST_LONG_PARTS[0], ("rolling_digest",))):
        rng = np.random.default_rng(B)
        payload = torch.from_numpy(rng.integers(
            32, 127, size=(B, STREAM_LEN), dtype=np.uint8)).to(dev)
        value = torch.from_numpy(rng.random(B, dtype=np.float32)).to(dev)
        fns = {
            "parse_xml": (lambda: so_kernel.parse_xml_fwd(payload),
                          lambda: so_ref.parse_xml_reference(payload),
                          B * STREAM_LEN + 8 * B, 4 * B * STREAM_LEN),
            "viete_pi": (lambda: so_kernel.viete_pi_fwd(value),
                         lambda: so_ref.viete_pi_reference(B, dev), 4 * B,
                         58 * B),
            "rolling_digest": (lambda: so_kernel.rolling_digest_fwd(value),
                               lambda: so_ref.rolling_digest_reference(value),
                               8 * B, 2 * B),
            "external_service": (
                lambda: so_kernel.external_service_fwd(value),
                lambda: so_ref.external_service_reference(value), 8 * B,
                B + 3 * so_ref.SERVICE_WORK),
        }
        for name in names:
            kern, plain, nbytes, ops = fns[name]
            ev = time_abba({"kernel": kern, "plain": plain},
                           ("plain", "kernel"))
            k_ms, _ = device_ms(kern, required=False)
            p_ms, _ = device_ms(plain, required=False)
            bound_ms, bound_by = bound(ops, nbytes, PEAK_FP32)
            chain = stream_chain(name, B)
            cycles = floor_ms = None
            if chain is not None:
                cycles = sum(n * probe["cycles"][k] for k, n in chain.items())
                # the part's first read may overlap the launch time that the
                # empty kernel already counts: it adds only beyond that
                load = chain.get("load", 0) * probe["cycles"]["load"]
                floor_ms = (max(probe["empty_ms"],
                                load / probe["clock_hz"] * 1e3)
                            + (cycles - load) / probe["clock_hz"] * 1e3)
            timing.setdefault(name, {})[B] = {
                "ms": k_ms, "event_ms": ev["kernel"], "plain_ms": p_ms,
                "plain_event_ms": ev["plain"], "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                "latency_floor_ms": floor_ms, "chain": chain,
                "chain_cycles": cycles}
            print(f"stream timing [{name}, B={B}]: device ms kernel "
                  + (f"{k_ms:.7f}" if k_ms is not None else "not measured")
                  + " plain " + (f"{p_ms:.7f}" if p_ms is not None
                                 else "not measured")
                  + f" (profiler, 20 calls); event ms kernel "
                  f"{ev['kernel']:.7f} plain {ev['plain']:.7f} (ABBA); "
                  f"roofline bound_ms {bound_ms:.10f} ({bound_by}: {nbytes} "
                  f"B, {ops} FP32-rate ops); latency floor ms "
                  + ("none (a kernel a pass, not one chain)" if chain is None
                     else f"{floor_ms:.7f} (the larger of an empty kernel "
                     f"{probe['empty_ms']:.7f} and the first read, + the rest "
                     f"of a chain of {cycles:.0f} cycles: "
                     + ", ".join(f"{n} x {k}" for k, n in chain.items())
                     + f", at {probe['clock_hz'] / 1e6:.0f} MHz)"),
                  flush=True)
    return worst, {"timing": timing, "probe": probe,
                   "launch_path_ns": launch_path_split(dev)}


def stream_phase(dev: torch.device) -> tuple:
    """Phase 9; returns the operator kernels' entries of the kernels line
    and the sweep launches of the runtime's co-simulations."""
    import repro_torch.core as core
    import repro_torch.runtime as rt
    from repro_torch.kernels.stream_ops import kernel as so_kernel
    from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
    from repro_torch.runtime import operators

    lib = core.paper_library()
    cpu = torch.device("cpu")
    result: dict = {}

    # 9a. the four kernels against their plain versions on the card, to 0 ------
    worst, kernels_9a = stream_kernel_phase(dev)
    timing = kernels_9a["timing"]
    result.update(kernels_9a)
    result["timing"] = {n: {str(b): t for b, t in v.items()}
                        for n, v in timing.items()}

    # parse_xml's launches on the main path by path (each read right after a
    # card run, as the launch counts are)
    main_paths = dict.fromkeys(so_kernel.PARSE_XML_PATHS, 0)

    def note_paths():
        for path, n in so_kernel.parse_xml_path_count().items():
            main_paths[path] += n

    # 9b. the chaos day on the card and on the CPU ----------------------------------
    days, launches_by_path = {}, {}
    for device in (dev, cpu):
        fleet, spawned = recording_fleet(
            rt, core.FleetController(lib, budget_slots=CHAOS_BUDGET),
            fault_plan=chaos_fault_plan(rt), clock=rt.VirtualClock(),
            frames_per_event=CHAOS_FRAMES, batch=CHAOS_BATCH, device=device)
        so_kernel.reset_launch_count()
        t0 = time.perf_counter()
        for i, ev in enumerate(chaos_events(core)):
            fleet.apply(ev, at=float(i))
        if device == dev:
            torch.cuda.synchronize()
            note_paths()
        wall = time.perf_counter() - t0
        days[device.type] = (fleet, so_kernel.launch_count(),
                        kernel_calls(operators, spawned), wall)
    (fc, lc, calls_c, wall_c), (fh, lh, calls_h, wall_h) = \
        days[dev.type], days["cpu"]
    same = (fc.log.rates_sequence() == fh.log.rates_sequence()
            and fc.log.timeline.signature() == fh.log.timeline.signature()
            and [enact_record(r) for r in fc.log.records]
            == [enact_record(r) for r in fh.log.records])
    ok = same and lc == calls_c and calls_c == calls_h and \
        sum(lh.values()) == 0 and sum(lc.values()) > 0
    reports = [r for rec in fc.log.records
               for r in (*rec.reports.values(),
                         *rec.recovery_reports.values())]
    esc = [e for rec in fc.log.records for e in rec.escalations]
    launches_by_path["chaos_day"] = lc
    result["chaos_day"] = {
        "events": len(fc.log), "faults_injected": len(fc.log.timeline),
        "windows": len(reports),
        "frames_shed": sum(r.frames_shed for r in reports),
        "retries": sum(r.retries for r in reports),
        "frames_failed": sum(r.frames_failed for r in reports),
        "tuples_lost": sum(r.tuples_lost for r in reports),
        "escalations": [[d, v] for d, v in esc],
        "equal_to_cpu": same, "launches": lc, "operator_calls": calls_c,
        "wall_s_card": wall_c, "wall_s_cpu": wall_h}
    print(f"chaos day [bench_chaos: {len(fc.log)} events, "
          f"{CHAOS_BUDGET} slots, {CHAOS_FRAMES} frames an event, batch "
          f"{CHAOS_BATCH}, {len(fc.log.timeline)} faults]: card vs CPU "
          f"records, rates, fault timeline, reports, escalations {esc} and "
          f"rebinds equal {same}; launches {lc} = operator calls {calls_c} "
          f"(CPU run: {sum(lh.values())} launches); wall s card "
          f"{wall_c:.3f}, CPU {wall_h:.3f} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        fail("the chaos day on the card disagrees with the CPU run")

    # 9c. the recalibration rails ---------------------------------------------------
    wrong = scaled_library(core, lib, 2.0)
    rails = {}
    for device in (dev, cpu):
        fleet, spawned = recording_fleet(
            rt, core.FleetController(wrong, budget_slots=CHAOS_BUDGET),
            fault_plan=rt.FaultPlan.none(), clock=rt.VirtualClock(),
            truth=lib, frames_per_event=CHAOS_FRAMES, batch=CHAOS_BATCH,
            device=device)
        so_kernel.reset_launch_count()
        for i, ev in enumerate(chaos_events(core, CHAOS_TRACE[:8])):
            fleet.apply(ev, at=float(i))
        launches = so_kernel.launch_count()
        if device == dev:
            note_paths()
        ms = fleet.measurements()
        res = core.recalibrate(wrong, ms, alpha=0.9)
        rails[device.type] = ([(m.kind, m.task, m.tau, m.tuples, m.busy_seconds)
                          for m in ms], res.error_before, res.error_after,
                         sorted(res.changed_kinds), launches,
                         kernel_calls(operators, spawned))
    (ms_c, before, after, kinds, lc, calls_c), cpu_rail = \
        rails[dev.type], rails["cpu"]
    same = rails[dev.type][:4] == cpu_rail[:4]
    ok = (same and abs(before - 0.5) < 1e-12 and round(after, 4) == 0.0909
          and lc == calls_c and sum(cpu_rail[4].values()) == 0)
    launches_by_path["recalibration"] = lc
    result["recalibration"] = {
        "samples": len(ms_c), "error_before": before, "error_after": after,
        "kinds": kinds, "equal_to_cpu": same, "launches": lc}
    print(f"recalibration [bench_chaos's 2x mis-profiled tables, first 8 "
          f"events]: {len(ms_c)} samples, rate error {before:.4f} -> "
          f"{after:.4f} ({len(kinds)} kinds); equal to the CPU run {same}; "
          f"launches {lc} = operator calls {calls_c} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the recalibration rail on the card disagrees")

    autos = {}
    for device in (dev, cpu):
        policy = core.AutoRecalPolicy(threshold=AUTO_RECAL["threshold"],
                                      cooldown_events=AUTO_RECAL["cooldown"])
        fleet, spawned = recording_fleet(
            rt, core.FleetController(
                scaled_library(core, lib, 2.0, scale_static=False),
                budget_slots=AUTO_RECAL["budget"]),
            fault_plan=rt.FaultPlan.none(), clock=rt.VirtualClock(),
            truth=lib, auto_recal=policy, device=device)
        cosims, cosimulate = [], fleet.ctl.cosimulate

        def counted(**kw):
            cosims.append(kw)
            return cosimulate(**kw)
        fleet.ctl.cosimulate = counted
        so_kernel.reset_launch_count()
        sweep_kernel.reset_launch_count()
        rec = fleet.apply(core.DagArrive("d1", core.diamond_dag(),
                                         max_rate=AUTO_RECAL["rate"]), at=0.0)
        if device == dev:
            torch.cuda.synchronize()
            note_paths()
        res = fleet.recalibrations[0] if fleet.recalibrations else None
        autos[device.type] = (
            enact_record(rec), list(fleet.recal_ticks),
            res and (res.error_before, res.error_after,
                     sorted(res.changed_kinds)),
            so_kernel.launch_count(), kernel_calls(operators, spawned),
            sweep_kernel.launch_count(), len(cosims))
    (summary, ticks, errs, lc, calls_c, sweeps, n_cosim), cpu_auto = \
        autos[dev.type], autos["cpu"]
    same = autos[dev.type][:3] == cpu_auto[:3]
    ok = (same and ticks == [0] and errs is not None
          and round(errs[0], 3) == 0.357 and round(errs[1], 3) == 0.065
          and lc == calls_c and sweeps == n_cosim > 0
          and cpu_auto[5] == 0 and sum(cpu_auto[3].values()) == 0)
    launches_by_path["auto_recal"] = lc
    result["auto_recal"] = {
        "drift_magnitude": summary["drift_magnitude"],
        "drift_alerts": summary["drift_alerts"], "recal_ticks": ticks,
        "error_before": errs and errs[0], "error_after": errs and errs[1],
        "equal_to_cpu": same, "launches": lc, "sweep_launches": sweeps,
        "cosimulations": n_cosim}
    print(f"auto-recalibration [tests/test_obs.py's mis-profiled diamond at "
          f"{AUTO_RECAL['rate']:g} t/s]: drift "
          f"{summary['drift_magnitude']:.4f} > {AUTO_RECAL['threshold']}, "
          f"{summary['drift_alerts']} alert(s), recalibrated at ticks "
          f"{ticks}, rate error "
          + (f"{errs[0]:.4f} -> {errs[1]:.4f}" if errs else "none")
          + f"; equal to the CPU run {same}; operator launches {lc} = calls "
          f"{calls_c}; sweep launches {sweeps} = co-simulations {n_cosim} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the auto-recalibration rail on the card disagrees")

    # 9d. the stream on the card under WallClock -------------------------------------
    def drive(dag: str, rate: float):
        sched = core.plan(core.ALL_DAGS[dag](), rate, lib, allocator="mba",
                          mapper="sam")
        ex = rt.StreamExecutor(sched, lib, clock=rt.WallClock(),
                               device=dev)
        so_kernel.reset_launch_count()
        t0 = time.perf_counter()
        rep = ex.run(rate, n_frames=STREAM_FRAMES, batch=STREAM_BATCH)
        wall = time.perf_counter() - t0
        launches = so_kernel.launch_count()
        note_paths()
        calls = kernel_calls(operators, [ex])
        if launches != calls:
            fail(f"stream {dag} at {rate:g} t/s: launches {launches} != "
                 f"operator calls {calls}")
        ms = ex.measurements()
        # the reference's verdict judges the latency slope of the frames
        # that completed; its source waits for the executor, so a stream
        # that falls behind shows as lost throughput, not as a rising slope
        sustained = (rep.stable and rep.frames_shed == 0
                     and rep.frames_timed_out == 0
                     and rep.throughput >= 0.95 * rate)
        row = {"dag": dag, "rate": rate, "slots": len(sched.mapping.slots()),
               "frames": rep.frames, "throughput": rep.throughput,
               "mean_latency_s": rep.mean_latency,
               "p99_latency_s": rep.p99_latency,
               "latency_slope": rep.latency_slope, "stable": rep.stable,
               "sustained": sustained,
               "frames_shed": rep.frames_shed,
               "frames_timed_out": rep.frames_timed_out, "wall_s": wall,
               "launches": sum(launches.values()),
               "launches_per_frame": sum(launches.values()) / rep.frames,
               "measured_vs_table_rate_error": core.rate_error(lib, ms)}
        print(f"stream [{dag} at {rate:g} t/s, {row['slots']} slots, "
              f"{STREAM_FRAMES} frames of {STREAM_BATCH}, WallClock]: "
              f"throughput {rep.throughput:.3f} t/s, latency mean "
              f"{rep.mean_latency * 1e3:.3f} ms p99 "
              f"{rep.p99_latency * 1e3:.3f} ms, stable {rep.stable}, "
              f"sustained {sustained}, shed "
              f"{rep.frames_shed}, timed out {rep.frames_timed_out}; "
              f"{row['launches_per_frame']:.2f} launches a frame; measured "
              f"service vs the tables {row['measured_vs_table_rate_error']:.3f}"
              f"; wall {wall:.3f} s", flush=True)
        return row, ex, launches

    stream_launches = dict.fromkeys(STREAM_KERNELS, 0)
    rows, diamond_ex = [], None
    for dag in core.ALL_DAGS:
        row, ex, launches = drive(dag, STREAM_RATE)
        rows.append(row)
        for k, n in launches.items():
            stream_launches[k] += n
        if dag == "diamond":
            diamond_ex = ex
    ladder = [next(r for r in rows if r["dag"] == "diamond")]
    for rate in STREAM_LADDER[1:]:
        row, _, launches = drive("diamond", rate)
        ladder.append(row)
        for k, n in launches.items():
            stream_launches[k] += n
    launches_by_path["wallclock_stream"] = stream_launches
    unstable = [r["rate"] for r in ladder if not r["stable"]]
    unsustained = [r["rate"] for r in ladder if not r["sustained"]]
    print(f"stream ladder [diamond, planned at each rate]: stable (latency "
          f"slope) at {[r['rate'] for r in ladder if r['stable']]} t/s, "
          f"first unstable {unstable[0] if unstable else 'none'}; sustained "
          f"(stable, nothing shed or timed out, throughput >= 95% of the "
          f"rate) at {[r['rate'] for r in ladder if r['sustained']]} t/s, "
          f"first not sustained {unsustained[0] if unsustained else 'none'}",
          flush=True)
    if not all(r["sustained"] for r in rows):
        fail("a seed DAG's stream at its planned 100 t/s is not sustained")

    # one warm diamond frame traced (its waits on the WallClock included)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    source = rt.SyntheticSource(STREAM_RATE, batch=STREAM_BATCH, seed=1,
                                clock=rt.VirtualClock(), device=dev)
    frames = source.frames(n_frames=4)
    diamond_ex.process_frame(next(frames), 0.0)
    for attempt in (1, 2, 3):     # a trace may come back without the device
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            status, _ = diamond_ex.process_frame(next(frames), 0.0)
            torch.cuda.synchronize()
            frame_wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
        print(f"stream frame trace {attempt}: no device kernel", flush=True)
    by_name: dict = {}
    for e in kernels:
        label = kernel_label(e.name)
        by_name[label] = by_name.get(label, 0.0) + e.time_range.elapsed_us()
    trace = {"dag": "diamond", "status": status,
             "device_kernels": len(kernels),
             "device_ms": (sum(by_name.values()) / 1e3 if kernels
                           else None), "wall_ms": frame_wall,
             "kernels_us": by_name}
    print(f"stream frame trace [diamond at {STREAM_RATE:g} t/s, one warm "
          f"frame, WallClock executor]: {len(kernels)} device kernels, device "
          + (f"{trace['device_ms']:.6f} ms" if kernels else "not measured")
          + f" of {frame_wall:.3f} ms wall ("
          + ", ".join(f"{k} {v:.3f} us" for k, v in sorted(by_name.items()))
          + ")", flush=True)
    if status != "ok":
        fail("the traced stream frame did not complete")
    # the frame's host time split: the same warm frames through the
    # WallClock executor (a synchronisation after every part, the service
    # waits slept) and through one on a VirtualClock (neither)
    source = rt.SyntheticSource(STREAM_RATE, batch=STREAM_BATCH, seed=2,
                                clock=rt.VirtualClock(), device=dev)
    frames = list(source.frames(n_frames=21))
    virtual_ex = rt.StreamExecutor(diamond_ex.schedule, lib,
                                   clock=rt.VirtualClock(), device=dev)
    split = {}
    for label, ex in (("wallclock", diamond_ex), ("virtual", virtual_ex)):
        walls = []
        for f in frames:
            t0 = time.perf_counter()
            ex.process_frame(f, 0.0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        split[label] = float(np.median(walls[1:]))
    trace["frame_ms_p50"] = split
    print(f"stream frame split [diamond at {STREAM_RATE:g} t/s, 20 warm "
          f"frames, median ms]: WallClock executor {split['wallclock']:.3f} "
          f"(a synchronisation after each part, service waits slept), "
          f"VirtualClock executor {split['virtual']:.3f} (launches only)",
          flush=True)
    parse_launches = sum(c["parse_xml"] for c in launches_by_path.values())
    vector_only = (main_paths["byte"] == 0
                   and main_paths["vector"] == parse_launches > 0)
    print(f"stream parse_xml paths [the main path: chaos day, recalibration, "
          f"auto-recalibration, WallClock streams]: {main_paths} of "
          f"{parse_launches} launches "
          f"{'ok: every part took the vector path' if vector_only else 'MISMATCH'}",
          flush=True)
    if not vector_only:
        fail("the runtime's parts did not all take parse_xml's vector path")
    result.update(stream=rows, ladder=ladder, frame_trace=trace,
                  launches_by_path=launches_by_path,
                  parse_xml_paths=main_paths)
    print(json.dumps({"stream": result}), flush=True)

    entries = []
    for name, replaces in STREAM_KERNELS.items():
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()}
        t = timing[name][STREAM_BATCH]
        entries.append({
            "name": f"{name}_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/stream_ops/csrc/stream_ops.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": worst[name],
            "ms": t["ms"] if t["ms"] is not None else t["event_ms"],
            "ms_source": ("device (profiler)" if t["ms"] is not None
                          else "events (the profiler saw no kernel)"),
            "event_ms": t["event_ms"],
            "plain_ms": (t["plain_ms"] if t["plain_ms"] is not None
                         else t["plain_event_ms"]),
            "plain_event_ms": t["plain_event_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "latency_floor_ms": t["latency_floor_ms"],
            "library_ms": None, "part_tuples": STREAM_BATCH,
            **({"paths": main_paths} if name == "parse_xml" else {})})
    return entries, result["auto_recal"]["sweep_launches"]


def serve_phase(dev: torch.device, port_kernels: set,
                phase5: dict) -> dict:
    """Phases 4 and 5; returns each kernel's launches by served model and
    keeps minicpm-2b's greedy tokens and first prompt's logits in
    ``phase5``."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.distributed.roofline import H100_SXM
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.moe_grouped import kernel as moe_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import run_serving
    from repro_torch.serve import plan_serving
    from repro_torch.serve.engine import GRAPH_WARMUP

    # 4. plan -------------------------------------------------------------------
    print(H100_SXM.describe())
    for arch in SERVED:
        sp = plan_serving(get_config(arch), request_rate=4.0,
                          prompt_len=PROMPT_LEN, gen_len=NEW_TOKENS,
                          hardware=H100_SXM)
        print(f"[{arch}] {sp.describe()}")
        print(sp.schedule.describe(), flush=True)

    # 5. serve at full width (and depth, but for DEPTH_CUTS) -------------------------
    counters = {"flash": kernel, "ssd": ssd_kernel, "moe": moe_kernel,
                "decode_attn": da_kernel}
    launches = {name: {} for name in counters}
    for arch in SERVED:
        published = get_config(arch)
        cfg = dataclasses.replace(
            published, num_layers=DEPTH_CUTS.get(arch, published.num_layers))
        n_shared = cfg.num_layers // cfg.attn_period if cfg.attn_period else 0
        kinds = cfg.layer_kinds
        per_prefill = {
            # causal prompt attention: every attention layer of a decoder,
            # the encoder-decoder's decoder self-attention (its encoder and
            # cross-attention are plain tensor code), the hybrid's shared
            # block
            "flash": (n_shared if cfg.family == "hybrid" else
                      kinds.count("*")),
            "ssd": kinds.count("M"),
            "moe": kinds.count("E")}
        for mod in counters.values():
            mod.reset_launch_count()
        obs.reset_metrics()
        obs.enable_metrics(True)
        try:
            res = run_serving(cfg, device="cuda", requests=REQUESTS,
                              prompt_len=PROMPT_LEN, max_new=NEW_TOKENS,
                              max_batch=MAX_BATCH, seed=SEED)
            decode_calls = obs.snapshot().get(
                "attn.decode_kernel_calls", {}).get("value", 0)
        finally:
            obs.disable_metrics()
            obs.reset_metrics()
        counts = {name: mod.launch_count() for name, mod in counters.items()}
        expected = {name: n * REQUESTS for name, n in per_prefill.items()}
        # the MoE also runs in the decode step, which the engine calls
        # eagerly GRAPH_WARMUP times and once more in the capture at its
        # construction; the graph's replays make no call.  So does the
        # decode attention, once in each layer that holds a K/V cache (the
        # layers flash runs in a prefill; whisper's cross-attention, which
        # takes no lengths, stays plain)
        expected["moe"] = per_prefill["moe"] * (REQUESTS + GRAPH_WARMUP + 1)
        expected["decode_attn"] = per_prefill["flash"] * (GRAPH_WARMUP + 1)
        for name, n in counts.items():
            launches[name][arch] = n
        done = res["done"]
        print(json.dumps({"serving": {
            "arch": cfg.name, "family": cfg.family,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "reduced": ({"num_layers": [cfg.num_layers, published.num_layers]}
                        if cfg.num_layers != published.num_layers else None),
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
            "moe_launches": counts["moe"],
            "decode_attn_launches": counts["decode_attn"],
            "decode_kernel_calls": decode_calls,
            "expected_launches": expected}}), flush=True)
        if counts != expected:
            fail(f"{arch}: kernel launches {counts}, expected {expected}")
        if decode_calls != expected["decode_attn"]:
            fail(f"{arch}: attn.decode_kernel_calls {decode_calls}, not the "
                 f"{expected['decode_attn']} attention layers' calls at the "
                 "decode graph's warm-up and capture")
        if len(done) != REQUESTS or any(len(r.output) != NEW_TOKENS
                                        for r in done):
            fail(f"{arch}: not every request finished with its tokens")
        if any(not 0 <= t < cfg.vocab_size for r in done for t in r.output):
            fail(f"{arch}: a generated token is outside the vocabulary")
        if not res["peak_mem_bytes"] < CARD_BYTES:
            fail(f"{arch}: peak device memory {res['peak_mem_bytes']} B is "
                 f"not under {CARD_BYTES:.0f}")
        eng = res["engine"]
        batch = eng.prefill_batch(done[0].prompt)
        prompt = batch["tokens"]
        profile_steps(eng, batch, {
            "tokens": prompt[:, :1].expand(MAX_BATCH, 1).contiguous(),
            "pos": torch.full((MAX_BATCH,), PROMPT_LEN + NEW_TOKENS,
                              device=dev)},
            {"prefill": res["prefill_ms_p50"],
             "decode": res["decode_ms_p50"]}, port_kernels)
        logits, _ = eng.api.prefill(eng.env, eng.params, batch,
                                    max_len=eng.max_len)
        if logits.shape != (1, 1, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"{arch}: full-size prefill logits are not finite of shape "
                 "(1, 1, V)")
        if arch == "minicpm-2b":        # what phase 12 holds tp 1 against
            phase5.update(outputs={r.rid: list(r.output) for r in done},
                          logits=logits[0, -1].float().cpu())
        del eng, res, logits, done, prompt, batch
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def agreement_phase(dev: torch.device) -> None:
    """Phase 6."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_config
    from repro_torch.models import Env, get_model
    from repro_torch.models import moe as moe_module
    from repro_torch.serve import ServeEngine

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
    stubs = np.random.default_rng(SEED + 1)
    for arch in AGREEMENT:
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
        # the compared prefill takes seeded frames / patch embeddings: the
        # engine's zero stand-ins would leave the freshly drawn encoder
        # (zero biases) and its cross-attention nothing but zeros to carry
        extra = {}
        if small.family == "audio":
            extra["frames"] = stubs.normal(
                size=(1, small.encoder_seq, small.d_model))
        if small.family == "vlm":
            extra["patch_embeds"] = stubs.normal(
                size=(1, small.num_patches, small.d_model))
        got, routes = {}, {}
        for name, env in envs.items():
            batch = {"tokens": torch.as_tensor(prompts[:1], dtype=torch.long,
                                               device=env.device),
                     **{k: torch.as_tensor(v, dtype=torch.float32,
                                           device=env.device)
                        for k, v in extra.items()}}
            # the routes of the prefill and of one eager decode step on its
            # cache: the engine on the card replays its decode step as a
            # CUDA graph, which calls no Python, so its greedy tokens are
            # what holds the replays to the CPU
            with recorded_calls(moe_module, "_route") as calls:
                lg, cache = api.prefill(env, params[name], batch,
                                        max_len=120)
                cache = {k: t.cpu().clone() for k, t in cache.items()}
                dlg, _ = api.decode_step(
                    env, params[name],
                    {k: t.to(env.device, copy=True) for k, t in cache.items()},
                    {"tokens": torch.as_tensor(prompts[1:2, :1],
                                               dtype=torch.long,
                                               device=env.device),
                     "pos": torch.full((1,), prompts.shape[1],
                                       dtype=torch.long, device=env.device)})
            routes[name] = [tuple(t.cpu() for t in out)
                            for _, _, out in calls]
            engine = ServeEngine(api, env, params[name], max_batch=2,
                                 max_len=120)
            for p, budget in zip(prompts, (6, 9, 4, 8, 5)):
                engine.submit(p, max_new_tokens=budget)
            outs = {r.rid: r.output for r in engine.run()}
            got[name] = (lg.cpu(), cache, outs, dlg.cpu())
        logit_err = float((got["cpu"][0] - got["cuda"][0]).abs().max())
        decode_err = float((got["cpu"][3] - got["cuda"][3]).abs().max())
        cache_err = {k: float((t - got["cuda"][1][k]).abs().max())
                     for k, t in got["cpu"][1].items()}
        same_tokens = got["cpu"][2] == got["cuda"][2]
        route_note, same_routes = "", True
        if small.family == "moe":
            k = small.experts_per_token
            gaps = [float((pr.sort(dim=-1, descending=True).values[:, k - 1]
                           - pr.sort(dim=-1, descending=True).values[:, k])
                          .min()) for pr, _, _ in routes["cuda"]]
            same_routes = len(routes["cpu"]) == len(routes["cuda"]) and all(
                torch.equal(c[2], g[2])
                for c, g in zip(routes["cpu"], routes["cuda"]))
            route_note = (
                f"; router: {len(routes['cuda'])} calls, "
                f"{sum(r[2].shape[0] for r in routes['cuda'])} tokens routed "
                f"to {k} of {small.num_experts} experts, smallest gap between "
                f"the k-th and (k+1)-th probability {min(gaps):.3g}, routing "
                f"decisions equal: {same_routes}")
        print(f"agreement at {small.name} fp32 (prompt 100"
              + (f", ssm_chunk {small.ssm_chunk}" if small.ssm_state else "")
              + (f", attn_period {small.attn_period}" if small.attn_period
                 else "")
              + (f", seeded {'/'.join(sorted(extra))}" if extra else "")
              + f"): prefill logits max_abs_err {logit_err:.3g}, cache "
              + ", ".join(f"{k} {e:.3g}" for k, e in sorted(cache_err.items()))
              + f", one eager decode step's logits {decode_err:.3g}"
              + f" (tol 1e-4); greedy tokens of 5 requests equal: "
              f"{same_tokens}" + route_note, flush=True)
        if not same_routes:
            fail(f"{arch}: a routing decision on the card differs from the "
                 "CPU's")
        if logit_err > 1e-4 or max(cache_err.values()) > 1e-4 or \
                decode_err > 1e-4 or not same_tokens:
            fail(f"{arch}: the port on the card disagrees with the same "
                 "model on the CPU")


# phase 10: training at full width and depth on the card, neither batch nor
# depth cut: minicpm-2b's fp32 master, AdamW moments and bf16 working copy
# and gradients are 43.6 GB (its peak with activations, the head's logits and
# one layer's plain fp32 attention backward was 49.2 GB on "NVIDIA H100 80GB
# HBM3, 700.00 W"); mamba2-370m's are 5.9 GB
TRAINED = ("minicpm-2b", "mamba2-370m")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
# (a) the kernels under autograd: forward at phase 3's tolerances; the
# gradients against autograd through the plain version on the same inputs
# (bf16 tolerance), a plumbing check only (hd padding, argument order,
# which output each gradient belongs to): the backward is that very
# computation.  Gradient parity is held on the CPU against the reference's
# custom_vjp (tests/test_torch_train_kernels.py)
TRAIN_GRAD_TOL = 2e-2
# (d) one fp32 train step on the card against the CPU: loss 1e-4; each
# gradient and moment leaf 1e-4 relative and 1e-4 of the leaf's largest
# element (up to 1), floor 1e-8; new params 1e-4 relative plus 1e-4 of lr,
# plus what the two clipped gradients' difference moves AdamW's first step
# (see train_agreement)
TRAIN_AGREE_TOL = 1e-4
TRAIN_AGREE_OPT = dict(lr=1e-3, warmup=0, total_steps=10)
# (e) the loss of the steps after a restore against the uninterrupted run's
# (bf16 compute; the embedding's backward adds by atomics on the card)
RESUME_TOL = 1e-3


def train_kernel_checks(dev: torch.device) -> dict:
    """Phase 10a: flash and SSD under autograd at the training shapes."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def plain_flash(q, k, v):
        return reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)

    def grads(fn, inputs, weights):
        ts = [t.detach().clone().requires_grad_() for t in inputs]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward(outs, [w.to(o.dtype)
                                       for o, w in zip(outs, weights)])
        return [o.detach() for o in outs], [t.grad for t in ts]

    def err(a, b, tol):
        d = (a.float() - b.float()).abs()
        return float(d.max()), bool(
            torch.isfinite(a.float()).all()
            and (d <= tol + tol * b.float().abs()).all())

    out = {}
    flash_cases = (("minicpm_train", TRAIN_BATCH, TRAIN_SEQ, 36, 36, 64),
                   ("gqa_train", 2, TRAIN_SEQ, 32, 8, 128),
                   # one rank's part on phase 13's (2, 2) mesh
                   ("minicpm_2x2_rank", 2, TRAIN_SEQ, 18, 18, 64),
                   ("minitron_2x2_rank", 2, TRAIN_SEQ, 12, 4, 128))
    for name, B, S, H, K, hd in flash_cases:
        inputs = (randn((B, S, H, hd)), randn((B, S, K, hd)),
                  randn((B, S, K, hd)))
        w = [randn((B, S, H, hd), torch.float32)]
        (y,), g = grads(ops.flash_attention, inputs, w)
        (y_ref,), g_ref = grads(plain_flash, inputs, w)
        fwd_err, fwd_ok = err(y, y_ref, TOLS[torch.bfloat16])
        g_errs = [err(a, b, TRAIN_GRAD_TOL) for a, b in zip(g, g_ref)]
        ok = fwd_ok and all(o for _, o in g_errs)
        print(f"train kernel [{name}] flash B={B} S={S} H={H} K={K} hd={hd} "
              f"bf16: forward max_abs_err {fwd_err:.3g} (tol "
              f"{TOLS[torch.bfloat16]:g} abs + rel), dq/dk/dv max_abs_err "
              + "/".join(f"{e:.3g}" for e, _ in g_errs)
              + f" (tol {TRAIN_GRAD_TOL:g} abs + rel; a plumbing check, hd "
              f"padding and argument order: the backward is autograd "
              f"through the plain version, so it reads 0 when wired right) "
              f"{'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"flash under autograd disagrees with the plain version on "
                 f"{name}")
        out[name] = fwd_err
        del inputs, w, y, y_ref, g, g_ref

    # one causal attention of minicpm's training step, forward and
    # backward: the port's op (kernel forward, plain recompute backward),
    # the plain version throughout, and SDPA's (a yardstick only)
    B, S, H, hd = TRAIN_BATCH, TRAIN_SEQ, 36, 64
    q, k, v = (randn((B, S, H, hd)).requires_grad_() for _ in range(3))
    g_out = randn((B, S, H, hd))

    def fwd_bwd(fn):
        def run():
            torch.autograd.backward(fn(q, k, v), g_out)
        return run
    fns = {"port": fwd_bwd(ops.flash_attention), "plain": fwd_bwd(plain_flash),
           "library": fwd_bwd(lambda q, k, v: torch.nn.functional
                              .scaled_dot_product_attention(
                                  q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), is_causal=True)
                              .transpose(1, 2))}
    ev = time_abba(fns, ("plain", "port", "library"))
    dev_ms = {n: device_ms(fn, iters=5, warmup=1)[0] for n, fn in fns.items()}
    print(f"train attention fwd+bwd at B={B} S={S} H=K={H} hd={hd} bf16, "
          f"device ms per call (profiler, 5 calls): port {dev_ms['port']:.6f} "
          f"plain {dev_ms['plain']:.6f} library (SDPA) "
          f"{dev_ms['library']:.6f}; event ms (ABBA): port {ev['port']:.6f} "
          f"plain {ev['plain']:.6f} library {ev['library']:.6f}", flush=True)
    out["attention_fwd_bwd_ms"] = dev_ms
    del q, k, v, g_out, fns

    P, N, chunk = 64, 128, 256
    # mamba2-370m's training shape, and one rank's part on phase 13's (2, 2)
    for name, Bt, H in (("mamba2_train", TRAIN_BATCH, 32),
                        ("mamba2_2x2_rank", 2, 16)):
        S = TRAIN_SEQ
        inputs = (randn((Bt, S, H, P)),
                  0.01 + 0.19 * torch.rand((Bt, S, H), generator=gen,
                                           device=dev),
                  -(0.5 + 1.5 * torch.rand((H,), generator=gen, device=dev)),
                  randn((Bt, S, N)), randn((Bt, S, N)))
        w = [randn((Bt, S, H, P), torch.float32),
             randn((Bt, H, P, N), torch.float32)]
        (y, s), g = grads(lambda *a: ssd_ops.ssd_scan(*a, chunk=chunk),
                          inputs, w)
        (y_ref, s_ref), g_ref = grads(
            lambda *a: ssd_reference(*a, chunk=chunk), inputs, w)
        y_err, y_ok = err(y, y_ref, SSD_Y_TOLS[torch.bfloat16])
        s_err, s_ok = err(s, s_ref, SSD_STATE_TOL)
        g_errs = [err(a, b, TRAIN_GRAD_TOL) for a, b in zip(g, g_ref)]
        ok = y_ok and s_ok and all(o for _, o in g_errs)
        print(f"train kernel [{name}] ssd Bt={Bt} S={S} H={H} P={P} N={N} "
              f"chunk={chunk} bf16: y max_abs_err {y_err:.3g} (tol "
              f"{SSD_Y_TOLS[torch.bfloat16]:g}), state {s_err:.3g} (tol "
              f"{SSD_STATE_TOL:g}); dx/ddt/dA/dB/dC max_abs_err "
              + "/".join(f"{e:.3g}" for e, _ in g_errs)
              + f" (tol {TRAIN_GRAD_TOL:g} abs + rel; a plumbing check: the "
              f"backward is autograd through the plain version, so it reads "
              f"0 when wired right) {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"SSD under autograd disagrees with the plain version on "
                 f"{name}")
        out[name] = y_err
        del inputs, w, y, s, y_ref, s_ref, g, g_ref
    return out


def profile_train_step(name: str, step_fn, state, batch, wall_ms: float,
                       ours: set) -> dict:
    """One traced train step: device kernels, busy ms and share of the
    untraced step's p50, the top kernels and the port's kernels' ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile [{name} train step]: the profiler saw no device "
              "kernels (busy share not measured)")
        return {"busy_share": None}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    port_ms: dict = {}
    for k, us in by_name.items():
        label = kernel_label(k)
        if label.split("<")[0] in ours:
            port_ms[label] = port_ms.get(label, 0.0) + us / 1e3
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rec = {"arch": name, "step": "train", "device_kernels": len(kernels),
           "device_busy_ms": busy_ms, "wall_ms_p50": wall_ms,
           "busy_share": busy_ms / wall_ms, "port_kernels_ms": port_ms,
           "top_ms": [[k[:100], v / 1e3] for k, v in top]}
    print(json.dumps({"profile": rec}), flush=True)
    return rec


def train_runs(dev: torch.device, ours: set, losses_out: dict) -> dict:
    """Phase 10b-c: each TRAINED model through launch/train.py's
    ``run_training`` with both launch counts set to 0 just before and read
    just after; returns each kernel's launches by model and puts each
    model's losses in ``losses_out`` (phase 13 holds its one-card mesh
    against them)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.train import run_training
    from repro_torch.train import AdamWConfig, adamw_update
    from repro_torch.train.tree import tree_map

    counters = {"flash": kernel, "ssd": ssd_kernel}
    launches = {name: {} for name in counters}
    for arch in TRAINED:
        cfg = get_config(arch)
        # remat runs each layer's forward twice a step: once forward, once
        # recomputed in the backward
        per_step = {"flash": 2 * (0 if cfg.family == "ssm" else
                                  cfg.num_layers),
                    "ssd": 2 * (cfg.num_layers if cfg.family == "ssm"
                                else 0)}
        for mod in counters.values():
            mod.reset_launch_count()
        res = run_training(cfg, device="cuda", steps=TRAIN_STEPS,
                           batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED,
                           log_every=TRAIN_STEPS)
        counts = {name: mod.launch_count() for name, mod in counters.items()}
        expected = {name: n * TRAIN_STEPS for name, n in per_step.items()}
        for name, n in counts.items():
            launches[name][arch] = n
        losses = res["losses"]
        losses_out[arch] = list(losses)
        rec = {
            "arch": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "params": cfg.param_count(),
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": res["steps"],
            "dtype": "bf16 compute, fp32 master and AdamW", "remat": True,
            "schedule": cfg.lr_schedule,
            "step_ms_p50": res["step_ms_p50"], "step_ms": res["step_ms"],
            "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
            "peak_mem_bytes": res["peak_mem_bytes"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "flash_launches": counts["flash"], "ssd_launches": counts["ssd"],
            "flash_per_step": counts["flash"] / res["steps"],
            "ssd_per_step": counts["ssd"] / res["steps"],
            "expected_launches": expected}
        print(json.dumps({"train": rec}), flush=True)
        if counts != expected:
            fail(f"{arch} training: kernel launches {counts}, expected "
                 f"{expected}")
        if not all(np.isfinite(losses)):
            fail(f"{arch} training: a loss is not finite: {losses}")
        if not res["peak_mem_bytes"] < CARD_BYTES:
            fail(f"{arch} training: peak device memory "
                 f"{res['peak_mem_bytes']} B is not under {CARD_BYTES:.0f}")
        profile_train_step(cfg.name, res["train_step"], res["state"],
                           res["batch"], res["step_ms_p50"], ours)
        # the optimizer's share of a step: one AdamW update of this state
        # (its cost does not depend on the gradients' values)
        state = res["state"]
        opt = AdamWConfig(warmup=10, total_steps=TRAIN_STEPS,
                          schedule=cfg.lr_schedule)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.bfloat16),
                         state.params)
        adamw_ms = time_ms(lambda: adamw_update(grads, state.opt,
                                                state.params, opt),
                           iters=3, warmup=1)
        print(f"train optimizer [{cfg.name}]: one adamw_update over "
              f"{cfg.param_count()} fp32 params (bf16 gradients, in place) "
              f"{adamw_ms:.3f} ms (events, 3 calls) of the step's "
              f"{res['step_ms_p50']:.3f} ms p50", flush=True)
        del res, state, grads
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def first_step_slack(mu_a: torch.Tensor, mu_b: torch.Tensor, opt
                     ) -> torch.Tensor:
    """Per element, what AdamW's first step may move a param by when two
    steps' clipped gradients differ: it moves an element by lr u(G), u(G) =
    G / (|G| + eps), G the clipped gradient, mu = (1 - b1) G.  By the mean
    value theorem |u(G_a) - u(G_b)| <= eps |G_a - G_b| / (m + eps)^2, m the
    smaller |G| (0 where the signs differ); times lr (the first step's is at
    most ``opt.lr``), capped at 2 lr."""
    g_a = mu_a.float() / (1 - opt.b1)
    g_b = mu_b.float() / (1 - opt.b1)
    m = torch.where(g_a * g_b > 0, torch.minimum(g_a.abs(), g_b.abs()), 0.0)
    return opt.lr * torch.clamp(opt.eps * (g_a - g_b).abs()
                                / (m + opt.eps) ** 2, max=2.0)


def train_agreement(dev: torch.device) -> None:
    """Phase 10d: one fp32 train step of each family at a small size on the
    card against the same step on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_config
    from repro_torch.models import Env, get_model
    from repro_torch.models import moe as moe_module
    from repro_torch.train import AdamWConfig, make_loss_fn, make_train_step
    from repro_torch.train.train_step import TrainState, _working_copy, \
        value_and_grad
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import tree_leaves_with_path, tree_map

    opt = AdamWConfig(**TRAIN_AGREE_OPT)
    envs = {"cpu": Env(torch.device("cpu"), torch.float32),
            "cuda": Env(dev, torch.float32)}
    rng = np.random.default_rng(SEED + 2)
    for arch in AGREEMENT:
        small = scale_config(get_config(arch), "10m")
        if small.family == "ssm":      # several chunks, the last one ragged
            small = dataclasses.replace(small, ssm_chunk=32)
        if small.family == "hybrid":   # the shared block runs at 4 layers
            small = dataclasses.replace(
                small, attn_period=small.num_layers // 2)
        api = get_model(small)
        params = api.init(torch.Generator().manual_seed(SEED), device="cpu")
        tokens = rng.integers(0, small.vocab_size, (2, 100))
        extra = {}
        if small.family == "audio":
            extra["frames"] = rng.normal(size=(2, small.encoder_seq,
                                               small.d_model))
        if small.family == "vlm":
            extra["patch_embeds"] = rng.normal(size=(2, small.num_patches,
                                                     small.d_model))
        got, routes = {}, {}
        for name, env in envs.items():
            batch = {"tokens": torch.as_tensor(tokens, device=env.device),
                     "labels": torch.as_tensor(np.roll(tokens, -1, axis=1),
                                               device=env.device),
                     **{k: torch.as_tensor(v, dtype=torch.float32,
                                           device=env.device)
                        for k, v in extra.items()}}
            # a copy on each device: the train step updates it in place
            p = tree_map(lambda t: t.to(env.device, copy=True), params)
            with recorded_calls(moe_module, "_route") as calls:
                (loss, _), grads = value_and_grad(
                    make_loss_fn(api, env), _working_copy(p, torch.float32),
                    batch)
                new, _ = make_train_step(api, env, opt)(
                    TrainState(p, adamw_init(p, opt)), batch)
            routes[name] = [out[2].cpu() for _, _, out in calls]
            got[name] = (float(loss),
                         [(k, t.cpu()) for k, t in
                          tree_leaves_with_path(grads)],
                         [(k, t.cpu()) for k, t in
                          tree_leaves_with_path(new)])
        def worst(pairs_cpu, pairs_card):
            """Largest difference, and whether each leaf is within
            TRAIN_AGREE_TOL relative and of the leaf's scale (up to 1)."""
            out, ok = 0.0, True
            for (_, a), (_, b) in zip(pairs_cpu, pairs_card):
                a, b = a.float(), b.float()
                d = (a - b).abs()
                out = max(out, float(d.max()))
                ok &= bool((d <= TRAIN_AGREE_TOL * a.abs() + TRAIN_AGREE_TOL
                            * min(1.0, float(a.abs().max())) + 1e-8).all())
            return out, ok

        def split(pairs, prefix):
            return [(k, t) for k, t in pairs if k.startswith(prefix)]
        loss_err = abs(got["cpu"][0] - got["cuda"][0])
        g_err, g_ok = worst(got["cpu"][1], got["cuda"][1])
        m_err, m_ok = worst(split(got["cpu"][2], "opt/"),
                            split(got["cuda"][2], "opt/"))
        # the params: 1e-4 relative plus 1e-4 of lr, plus what the two
        # devices' clipped gradients' difference moves the first step by
        # (first_step_slack; each device's G from its own mu)
        cpu_mu = dict(split(got["cpu"][2], "opt/mu/"))
        card_mu = dict(split(got["cuda"][2], "opt/mu/"))
        p_err, p_ok, n_wide, wide_g, wide_lr = 0.0, True, 0, 0.0, 0.0
        for (k, a), (_, b) in zip(split(got["cpu"][2], "params/"),
                                  split(got["cuda"][2], "params/")):
            key = "opt/mu/" + k[len("params/"):]
            moved = first_step_slack(cpu_mu[key], card_mu[key], opt)
            base = TRAIN_AGREE_TOL * a.abs() + TRAIN_AGREE_TOL * opt.lr
            wide = moved > base
            n_wide += int(wide.sum())
            if wide.any():
                g_a = cpu_mu[key].float() / (1 - opt.b1)
                wide_g = max(wide_g, float(g_a.abs()[wide].max()))
                wide_lr = max(wide_lr, float(moved.max()) / opt.lr)
            d = (a - b).abs()
            p_err = max(p_err, float(d.max()))
            p_ok &= bool((d <= base + moved).all())
        same_routes = len(routes["cpu"]) == len(routes["cuda"]) and all(
            torch.equal(a, b) for a, b in zip(routes["cpu"], routes["cuda"]))
        ok = (loss_err <= TRAIN_AGREE_TOL and g_ok and m_ok and p_ok
              and same_routes)
        print(f"train agreement at {small.name} fp32 (batch 2 x 100): loss "
              f"{got['cuda'][0]:.6f}, |card - cpu| {loss_err:.3g}; gradients "
              f"max_abs_err {g_err:.3g}, moments after one step {m_err:.3g} "
              f"(tol {TRAIN_AGREE_TOL:g} relative and of the leaf's scale); "
              f"params {p_err:.3g} (tol {TRAIN_AGREE_TOL:g} relative + "
              f"{TRAIN_AGREE_TOL:g} lr + lr eps |dG| / (min |G| + eps)^2, "
              f"the first step's sensitivity to the clipped gradients' "
              f"difference; wider than the base at {n_wide} elements, the "
              f"largest CPU |G| among them {wide_g:.3g}, the widest "
              f"{wide_lr:.3g} lr)"
              + (f"; routing decisions equal: {same_routes} "
                 f"({len(routes['cuda'])} router calls)"
                 if small.family == "moe" else "")
              + f" {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{arch}: a train step on the card disagrees with the CPU")


def train_resume(dev: torch.device) -> None:
    """Phase 10e: save after step 2, restore into a fresh state, the
    restored tensors bit-equal to the saved ones, and the next steps'
    losses against the uninterrupted run's."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.train import scale_config
    from repro_torch.models import default_env, get_model
    from repro_torch.train import (AdamWConfig, Checkpointer,
                                   init_train_state, make_train_step)
    from repro_torch.train.tree import tree_leaves_with_path

    cfg = scale_config(get_config("minicpm-2b"), "100m")
    api, env = get_model(cfg), default_env(dev)
    opt = AdamWConfig(lr=1e-3, warmup=2, total_steps=20,
                      schedule=cfg.lr_schedule, mu_dtype=torch.bfloat16)
    src = SyntheticTokens(256, 4, cfg.vocab_size, seed=SEED)
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in src.next().items()} for _ in range(4)]
    step = make_train_step(api, env, opt)

    def fresh(seed):
        return init_train_state(api, torch.Generator(device=dev)
                                .manual_seed(seed), opt, device=dev)
    state = fresh(SEED)
    for b in batches[:2]:
        state, _ = step(state, b)
    saved = [(k, t.clone()) for k, t in tree_leaves_with_path(state)]
    build = HERE / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        ckpt = Checkpointer(d)
        t0 = time.perf_counter()
        ckpt.save(2, state, extra={"arch": cfg.name})
        t_snap = time.perf_counter() - t0
        ckpt.wait()
        t_write = time.perf_counter() - t0
        restored, at, extra = ckpt.restore(fresh(SEED + 1))
    leaves = tree_leaves_with_path(restored)
    equal = at == 2 and [k for k, _ in leaves] == [k for k, _ in saved] and \
        all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(leaves, saved))
    losses = {"uninterrupted": [], "restored": []}
    for name, st in (("uninterrupted", state), ("restored", restored)):
        for b in batches[2:]:
            st, m = step(st, b)
            losses[name].append(float(m["loss"]))
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses["restored"],
                                                  losses["uninterrupted"])]
    ok = equal and max(diffs) <= RESUME_TOL
    nbytes = sum(t.numel() * t.element_size() for _, t in saved)
    print(f"train resume [{cfg.name} bf16, bf16 mu, batch 4 x 256]: "
          f"{len(saved)} leaves, {nbytes} B saved at step 2 (snapshot "
          f"{t_snap:.3f} s, written {t_write:.3f} s), restored on {dev} "
          f"bit-equal: {equal}; steps 3-4 loss restored "
          f"{losses['restored']} vs uninterrupted {losses['uninterrupted']}, "
          f"relative difference {max(diffs):.3g} (tol {RESUME_TOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("a checkpoint restored on the card does not resume the run")


def launch_total(by_path: dict) -> int:
    """Launches of a nested {path: count or {model: count}} record."""
    return sum(launch_total(v) if isinstance(v, dict) else v
               for v in by_path.values())


def train_phase(dev: torch.device, ours: set, losses_out: dict) -> dict:
    """Phase 10; returns each kernel's launches by trained model (and each
    model's losses in ``losses_out``)."""
    train_kernel_checks(dev)
    launches = train_runs(dev, ours, losses_out)
    train_agreement(dev)
    train_resume(dev)
    return launches


# phase 11: the analysis CLI.  prove --simulate at the CLI's defaults (the
# reference's CI, ci.yml:53) and at 120 slots / 3000 t/s, with the cells the
# reference's run decides at each
PROVE_RUNS = (("12 slots, 300 t/s", (), "27/27"),
              ("120 slots, 3000 t/s",
               ("--budget-slots", "120", "--max-rate", "3000"), "21/27"))
#: the reference CI's wall budget for lint + flow over src/ (ci.yml:64-75)
CI_BUDGET_MS = 30e3
#: the codes tests/test_flow.py expects of each flow fixture
FLOW_FIXTURES = {"abba_deadlock.py": ["RACE210"],
                 "lock_across_join.py": ["RACE211"],
                 "hand_over_hand.py": []}


def run_cli(main_fn, argv) -> tuple:
    """(exit code, standard output, wall ms) of one in-process call of a
    CLI's ``main``; its standard error passes through."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = main_fn(list(argv))
    return code, out.getvalue(), (time.perf_counter() - t0) * 1e3


def prove_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("prove:")]


def analysis_phase() -> int:
    """Phase 11; returns the sweep launches of its ``prove --simulate``
    runs."""
    import repro_torch.core as core
    from repro_torch.analysis.__main__ import main as cli
    from repro_torch.core import online as online_mod
    from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
    from repro_torch.kernels.sweep_scan.ref import (n_samples_of,
                                                    sweep_scan_reference)

    proves, launches_total = [], 0
    for label, extra, decided in PROVE_RUNS:
        argv = ["prove", "--simulate", *extra]
        # the main path: the CLI's co-simulation on the card, counted
        with recorded_calls(online_mod, "simulate_fleet") as sims, \
                recorded_calls(core.SweepBatch, "sweep_raw") as raws, \
                recorded_calls(sweep_kernel, "sweep_scan_fwd") as calls:
            sweep_kernel.reset_launch_count()
            code, out, wall_ms = run_cli(cli, argv)
            launches = sweep_kernel.launch_count()
        launches_total += launches
        if launches != 1 or len(calls) != 1 or len(sims) != 1:
            fail(f"prove --simulate [{label}]: {launches} sweep launches, "
                 "expected 1")
        cpu_code, cpu_out, cpu_wall_ms = run_cli(
            cli, argv + ["--device", "cpu"])
        (sim_args, sim_kw, rep), (args, kw, kern) = sims[0], calls[0]
        with recorded_calls(core.SweepBatch, "sweep_raw") as host_raws:
            t0 = time.perf_counter()
            rep_n = core.simulate_fleet(*sim_args,
                                        **{**sim_kw, "engine": "numpy"})
            numpy_ms = (time.perf_counter() - t0) * 1e3
        raw, host = raws[0][2], host_raws[0][2]
        err_numpy = max(max_err(getattr(raw, f), getattr(host, f))
                        for f in RAW_FIELDS)
        verdicts = {n: [r.stable for r in e.results]
                    for n, e in rep.entries.items()}
        ok_numpy = verdicts == {n: [r.stable for r in e.results]
                                for n, e in rep_n.entries.items()} and all(
            close_fields(getattr(raw, f), getattr(host, f), SWEEP_TOL)
            for f in RAW_FIELDS)
        err_plain, ok_plain, plain_ms = against_plain(
            sweep_scan_reference, args, kw, kern, PLAIN_TOL)
        dev_ms, dev_source = sweep_device_ms(
            lambda: sweep_kernel.sweep_scan_fwd(*args, **kw), iters=5)
        flops, nbytes, _ = sweep_work(
            args[6], args[0].cpu().numpy(), args[5].cpu().numpy(),
            kw["steps"], kw["s0"], n_samples_of(kw["steps"],
                                                kw["sample_every"]))
        bound_ms, bound_by = bound(flops, nbytes, PEAK_FP64)
        lines = prove_lines(out)
        same_lines = lines == prove_lines(cpu_out) and code == cpu_code
        clean = (code == 0 and f"prove: {decided} cells decided" in out
                 and "cross-check — 0 mismatch(es) over 27 cells" in out)
        ok = same_lines and clean and ok_numpy and ok_plain
        proves.append({
            "setting": label, "exit": code, "lines": lines,
            "launches": launches, "K": int(args[0].shape[2]),
            "steps": kw["steps"], "cli_wall_ms": wall_ms,
            "cli_cpu_wall_ms": cpu_wall_ms, "kernel_device_ms": dev_ms,
            "kernel_ms_source": dev_source, "plain_event_ms": plain_ms,
            "numpy_wall_ms": numpy_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err_vs_numpy": err_numpy,
            "max_abs_err_vs_plain": err_plain,
            "lines_equal_cpu": same_lines, **launch_report(sweep_kernel,
                                                           args, kw)})
        print(f"analysis prove --simulate [{label}]: exit {code}, "
              f"{lines[-2][len('prove: '):]}; {lines[-1][len('prove: '):]}; "
              f"{launches} sweep launch (K={proves[-1]['K']}, "
              f"{kw['steps']} ticks); lines and exit equal --device cpu: "
              f"{same_lines}; CLI wall ms {wall_ms:.3f} (cpu "
              f"{cpu_wall_ms:.3f}); kernel ms {dev_ms:.6f} ({dev_source}; "
              f"bound {bound_ms:.6f}, {bound_by}), plain event ms "
              f"{plain_ms:.3f}, numpy co-simulation wall ms {numpy_ms:.3f}; "
              f"kernel vs numpy max_abs_err {err_numpy:.3g} (tol "
              f"{SWEEP_TOL:g}), verdicts equal {ok_numpy}; vs plain on the "
              f"card {err_plain:.3g} (tol {PLAIN_TOL:g} abs + rel) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"prove --simulate [{label}] on the card disagrees")

    commands = {}
    code, out, commands["verify_smoke"] = run_cli(cli, ["--verify-smoke"])
    if code != 0 or out.strip() != "verify-smoke: clean":
        fail(f"--verify-smoke: exit {code}: {out.strip()[-400:]}")
    src = str(HERE / "src")
    for name, argv in (("lint_src", ["lint", src]),
                       ("flow_src", ["flow", src])):
        code, out, commands[name] = run_cli(cli, argv)
        if code != 0 or out.strip() != f"{argv[0]}: clean":
            fail(f"{argv[0]} src/: exit {code}: {out.strip()[-400:]}")
    sarif = HERE / "build" / "analysis" / "flow.sarif"
    sarif.parent.mkdir(parents=True, exist_ok=True)
    code, out, commands["flow_src_tests_benchmarks"] = run_cli(
        cli, ["flow", src, str(HERE / "tests"), str(HERE / "benchmarks"),
              "--sarif", str(sarif)])
    doc = json.loads(sarif.read_text())
    run = doc["runs"][0]
    if (code != 0 or out.strip() != "flow: clean" or run["results"]
            or run["tool"]["driver"]["name"] != "repro_torch.analysis"):
        fail(f"flow src/ tests/ benchmarks/: exit {code}: "
             f"{out.strip()[-400:]}")
    fixtures = HERE / "tests" / "fixtures" / "flow"
    code, out, commands["flow_fixtures"] = run_cli(
        cli, ["flow", str(fixtures), "--json"])
    found = {name: [] for name in FLOW_FIXTURES}
    for f in json.loads(out)["findings"]:
        found.setdefault(pathlib.Path(f["artifact"]).name, []).append(
            f["code"])
    if code != 1 or found != FLOW_FIXTURES:
        fail(f"flow tests/fixtures/flow/: exit {code}, codes {found}")
    budget_ms = commands["lint_src"] + commands["flow_src"]
    within = budget_ms < CI_BUDGET_MS
    print(f"analysis CLI: --verify-smoke clean; lint src/ clean, flow src/ "
          f"clean, flow src/ tests/ benchmarks/ --sarif clean (SARIF "
          f"{doc['version']}, 0 results); flow tests/fixtures/flow/ exit "
          f"{code}, codes {found}; wall ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in commands.items())
          + f"; lint + flow over src/ {budget_ms:.3f} ms (budget "
          f"{CI_BUDGET_MS:.0f}) {'ok' if within else 'OVER'}", flush=True)
    if not within:
        fail(f"lint + flow over src/ took {budget_ms:.0f} ms")
    print(json.dumps({"analysis": {
        "prove_simulate": proves, "wall_ms": commands,
        "lint_flow_src_ms": budget_ms, "fixture_codes": found}}),
        flush=True)
    return launches_total


# phase 12: sharded serving over R = torch.cuda.device_count() ranks, one
# card each (NCCL), started by the launcher's spawn helper and run through
# its rank entry (repro_torch.launch.serve.sharded_model/serve_workload).
# Every job serves REQUESTS prompts of PROMPT_LEN, NEW_TOKENS each, at full
# width; the counts are set to 0 in each rank just before its serving run
# and read just after.  On one card: minicpm-2b at full depth at tp 1
# against phase 5's one-device run.  On four: minicpm-2b at tp 4 (and its
# greedy tokens in fp32 against the one-device model's, 2 prompts of 256,
# 16 new tokens), qwen2-72b at all 80 layers (phase 5 holds 40 on one
# card), moonshot-v1-16b-a3b expert-parallel (its routing and drops against
# rank 0's recomputation from the layers' inputs), mamba2-370m (8 of its 32
# SSD heads a rank) and a 4-stage gpipe.  Other counts run minicpm-2b only.
SHARD_JOBS = {1: ("minicpm-2b",),
              4: ("minicpm-2b", "minicpm-2b fp32", "qwen2-72b",
                  "moonshot-v1-16b-a3b", "mamba2-370m", "gpipe")}
SHARD_FP32 = dict(requests=2, prompt_len=256, max_new=16, max_batch=2,
                  seed=SEED)
GPIPE = dict(layers=8, width=4096, microbatches=8, rows=64)


def predicted_collectives(cfg, tp: int, B: int, S: int, nbytes: int) -> dict:
    """The collectives one dense prefill (B, S) or decode step (S = 1)
    issues at tp: the vocab-parallel embedding's all-reduce (where the
    vocab divides), one after each layer's attention and one after its
    MLP (where heads and hidden divide), and the head's all-gather of the
    last position's logits."""
    vocab = cfg.vocab_size % tp == 0
    per_layer = (cfg.num_heads % tp == 0) + (cfg.d_ff % tp == 0)
    n_ar = int(vocab) + cfg.num_layers * per_layer
    act = B * S * cfg.d_model * nbytes
    out = {"counts": {}, "raw_bytes": {}, "wire_bytes": {}}
    if n_ar:
        out["counts"]["all-reduce"] = n_ar
        out["raw_bytes"]["all-reduce"] = n_ar * act
        out["wire_bytes"]["all-reduce"] = n_ar * act * 2 * (tp - 1) / tp
    if vocab:
        logits = B * cfg.vocab_size * nbytes
        out["counts"]["all-gather"] = 1
        out["raw_bytes"]["all-gather"] = logits
        out["wire_bytes"]["all-gather"] = logits * (tp - 1) / tp
    return out


def shard_serve(rank: int, tp: int, arch: str, dtype: torch.dtype,
                opts: dict, routes: bool) -> dict:
    """One serving job inside rank ``rank``: the launcher's rank entry at
    full width and depth, kernel launches counted around the serving run,
    collectives recorded over it and over one more prefill and decode
    step; for MoE, every rank's routing in that prefill and rank 0's
    recomputation of every rank's from the layers' inputs."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import recording
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import sharded_model, serve_workload
    from repro_torch.models import moe as moe_module, transformer

    cfg = get_config(arch)
    env, api, params = sharded_model(rank, tp, cfg, "cuda", opts["seed"],
                                     dtype)
    torch.cuda.synchronize()
    kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    with recording() as stats:
        res = serve_workload(env, api, params, **opts)
    counts = {"flash": kernel.launch_count(), "ssd": ssd_kernel.launch_count()}
    eng = res.pop("engine")
    batch = eng.prefill_batch(res["done"][0].prompt)
    steps, profiles = {}, {}
    with contextlib.ExitStack() as stack:
        calls = stack.enter_context(recorded_calls(moe_module,
                                                   "_dispatch_local"))
        inputs = stack.enter_context(recorded_calls(transformer, "moe_ffn"))
        with recording() as steps["prefill"], rank_profile(
                rank, profiles, "prefill"):
            logits, _ = api.prefill(env, params, batch, max_len=eng.max_len)
    with recording() as steps["decode"], rank_profile(rank, profiles,
                                                      "decode"):
        api.decode_step(env, params, eng.cache, {
            "tokens": batch["tokens"][:, :1].expand(eng.max_batch, 1),
            "pos": torch.full((eng.max_batch,), res["done"][0].prompt.size,
                              device=env.device)})
    torch.cuda.synchronize()
    out = {k: v for k, v in res.items() if k != "done"}
    out.update(
        outputs={r.rid: list(r.output) for r in res["done"]},
        first_rid=res["done"][0].rid, launches=counts,
        logits=logits[0, -1].float().cpu(),
        finite=bool(torch.isfinite(logits).all()),
        collectives=stats.as_dict(),
        step_collectives={k: v.as_dict() for k, v in steps.items()},
        profiles=profiles,
        layers=cfg.num_layers, d_model=cfg.d_model, family=cfg.family)
    if routes and cfg.family == "moe":
        out["routes"] = [(a[1].cpu(), o[2].cpu()) for a, _, o in calls]
        if rank == 0:
            out["recomputed"] = moe_recompute(cfg, tp, inputs)
    del eng, params, res, logits, calls, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def rank_profile(rank: int, out: dict, name: str):
    """On rank 0, trace the block with torch.profiler: its device kernels,
    their summed ms, the NCCL kernels' part, and the block's host ms (a
    synchronisation at its end); other ranks run the block untraced."""
    if rank != 0:
        yield
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    nccl = sum(e.time_range.elapsed_us() for e in kernels
               if "nccl" in e.name.lower()) / 1e3
    out[name] = {"device_kernels": len(kernels), "device_busy_ms": busy,
                 "nccl_ms": nccl, "traced_wall_ms": wall,
                 "busy_share": busy / wall if wall else None}


def moe_recompute(cfg, tp: int, inputs) -> list:
    """Per layer, every rank's routing recomputed without collectives from
    the layer's input (the whole sequence, which every rank holds) and the
    router: rank r's block of the sequence, top-k, capacity from its own
    token count, the dispatch's ``valid``."""
    import math
    from repro_torch.models import moe as moe_module
    out = []
    for (env, p, x), kw, _ in inputs:
        B, S, D = x.shape
        s_l, k = S // tp, kw["experts_per_token"]
        per_rank = []
        for r in range(tp):
            xf = x[:, r * s_l:(r + 1) * s_l].reshape(-1, D)
            _, _, top_ids = moe_module._route(xf, p["router"], k)
            ids = top_ids.reshape(-1)
            cap = max(int(math.ceil(xf.shape[0] * k * kw["capacity_factor"]
                                    / kw["num_experts"])), 1)
            _, _, valid = moe_module._dispatch_local(xf, ids, cap,
                                                     kw["num_experts"], k)
            per_rank.append((ids.cpu(), valid.cpu()))
        out.append(per_rank)
    return out


def shard_gpipe(rank: int, tp: int) -> dict:
    """A GPIPE-sized 4-stage pipeline of tanh(x @ W) layers in fp32, each
    rank holding its stage, against the layers run in sequence on rank 0."""
    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import gpipe, split_stages
    dev = torch.device("cuda", rank)
    L, d, n_mb, rows = (GPIPE[k] for k in ("layers", "width",
                                           "microbatches", "rows"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ws = torch.randn((L, d, d), generator=gen, device=dev) * d ** -0.5
    x = torch.randn((n_mb, rows, d), generator=gen, device=dev)
    mesh = Mesh.attach((tp,), ("pipe",), "cuda")
    mine = split_stages(ws, tp)[rank:rank + 1]

    def layer_fn(stage, c):
        for w in stage:
            c = torch.tanh(c @ w)
        return c
    f = gpipe(layer_fn, mesh, pipe_axis="pipe", n_microbatches=n_mb)
    f(mine, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording() as stats:
        y = f(mine, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ref = x
    for w in ws:
        ref = torch.tanh(ref @ w)
    return {"err": float((y - ref).abs().max()), "ms": ms,
            "stats": stats.as_dict(), "stages": tp, "microbatches": n_mb}


def shard_rank(rank: int, tp: int, jobs: tuple) -> dict:
    """Rank ``rank`` of phase 12: each job in turn, in one NCCL world."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    for job in jobs:
        if job == "gpipe":
            out[job] = shard_gpipe(rank, tp)
        elif job.endswith(" fp32"):
            arch = job.split()[0]
            out[job] = shard_serve(rank, tp, arch, torch.float32,
                                   SHARD_FP32, False)
            if rank == 0:      # the one-device model: tp 1's computation
                out[job]["one_device"] = one_device_outputs(arch)
        else:
            out[job] = shard_serve(rank, tp, job, torch.bfloat16, dict(
                requests=REQUESTS, prompt_len=PROMPT_LEN, max_new=NEW_TOKENS,
                max_batch=MAX_BATCH, seed=SEED), True)
        torch.distributed.barrier()
    return out


def one_device_outputs(arch: str) -> dict:
    """Greedy tokens of the fp32 job on the one-device model (no mesh) on
    card 0, the same weights drawn whole."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_workload
    from repro_torch.models import get_model
    from repro_torch.models.common import Env
    env = Env(torch.device("cuda", 0), torch.float32)
    api = get_model(get_config(arch))
    params = api.init(torch.Generator(device=env.device).manual_seed(SEED),
                      device=env.device, dtype=torch.float32)
    res = serve_workload(env, api, params, **SHARD_FP32)
    outs = {r.rid: list(r.output) for r in res["done"]}
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    return outs


def sharded_phase(phase5: dict) -> dict:
    """Phase 12; returns each kernel's launches (all ranks) by job."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.spawn import spawn
    R = torch.cuda.device_count()
    jobs = SHARD_JOBS.get(R, SHARD_JOBS[1])
    skipped = sorted(set(SHARD_JOBS[4]) - set(jobs))
    print(f"sharded serving: ranks {R} (NCCL, one card a rank); runs "
          f"{', '.join(jobs)}"
          + (f"; not run for want of 4 cards: {', '.join(skipped)}"
             if skipped else ""), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(shard_rank, R, args=(R, jobs), device="cuda", timeout=900)
    print(f"sharded serving: {R} ranks ran in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"flash": {}, "ssd": {}}
    for job in jobs:
        per = [r[job] for r in ranks]
        if job == "gpipe":
            g = per[0]
            ok = all(p["err"] <= 1e-4 for p in per) and all(
                p["stats"]["counts"] == {"collective-permute": n_mb + R - 1,
                                         "all-reduce": 1}
                for p, n_mb in ((p, p["microbatches"]) for p in per))
            print(f"sharded gpipe [{R} stages, {GPIPE['layers']} layers of "
                  f"tanh(x @ W), W {GPIPE['width']}^2, {GPIPE['microbatches']}"
                  f" microbatches of {GPIPE['rows']} rows, fp32]: max_abs_err "
                  f"vs sequential {max(p['err'] for p in per):.3g} (tol 1e-4),"
                  f" {g['ms']:.3f} ms, collectives {g['stats']['counts']} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail("gpipe over the ranks disagrees with the layers in "
                     "sequence")
            continue
        shard_check(job, per, R, phase5, launches)
    return launches


def shard_check(job: str, per: list, R: int, phase5: dict,
                launches: dict) -> None:
    from repro_torch.configs import get_config
    r0 = per[0]
    arch = job.split()[0]
    cfg = get_config(arch)
    family = r0["family"]
    n_flash = (0 if family == "ssm" else cfg.num_layers // cfg.attn_period
               if family == "hybrid" else cfg.num_layers)
    n_ssd = cfg.num_layers if family in ("ssm", "hybrid") else 0
    requests = r0["requests"]
    expected = {"flash": n_flash * requests, "ssd": n_ssd * requests}
    for p in per:
        if p["launches"] != expected:
            fail(f"{job}: a rank launched {p['launches']}, expected "
                 f"{expected}")
    if not all(p["finite"] for p in per):
        fail(f"{job}: prefill logits are not finite")
    if any(o != r0["outputs"] for o in (p["outputs"] for p in per)):
        fail(f"{job}: the ranks' greedy tokens differ")
    if any(len(t) != (NEW_TOKENS if not job.endswith("fp32") else
                      SHARD_FP32["max_new"]) for t in r0["outputs"].values()):
        fail(f"{job}: not every request finished with its tokens")
    if not all(p["peak_mem_bytes"] < CARD_BYTES for p in per):
        fail(f"{job}: a rank's peak memory is not under {CARD_BYTES:.0f}")
    if not job.endswith("fp32"):
        for name in ("flash", "ssd"):
            launches[name][f"{arch} tp{R}"] = sum(p["launches"][name]
                                                  for p in per)
    note = {}
    if family == "dense" and not job.endswith("fp32"):
        want = {"prefill": predicted_collectives(cfg, R, 1, PROMPT_LEN, 2),
                "decode": predicted_collectives(cfg, R, MAX_BATCH, 1, 2)}
        for step, w in want.items():
            got = r0["step_collectives"][step]
            if got["counts"] != w["counts"] or \
                    got["raw_bytes"] != w["raw_bytes"] or any(
                        abs(got["wire_bytes"][k] - v) > 1e-6
                        for k, v in w["wire_bytes"].items()):
                fail(f"{job}: {step} collectives {got} != predicted {w}")
        run = r0["collectives"]["counts"]
        want_run = {k: r0["prefills"] * want["prefill"]["counts"].get(k, 0)
                    + r0["decode_steps"] * want["decode"]["counts"].get(k, 0)
                    for k in set(want["prefill"]["counts"])
                    | set(want["decode"]["counts"])}
        if run != want_run:
            fail(f"{job}: the run's collectives {run} != predicted "
                 f"{want_run}")
        note["collectives_predicted"] = True
    if job == "minicpm-2b" and R == 1:
        same = r0["outputs"] == phase5["outputs"]
        err = float((r0["logits"] - phase5["logits"]).abs().max())
        tol = TOLS[torch.bfloat16] * (1 + float(phase5["logits"].abs().max()))
        print(f"sharded [{job} tp 1] vs phase 5's one-device run: greedy "
              f"tokens of {len(r0['outputs'])} requests equal: {same}; "
              f"prefill logits max_abs_err {err:.3g} (tol {tol:.3g}) "
              f"{'ok' if same and err <= tol else 'MISMATCH'}", flush=True)
        if not same or err > tol:
            fail("the sharded entry point at tp 1 disagrees with phase 5")
    if job == "minicpm-2b" and R > 1:
        agree = sum(a == b for rid in phase5["outputs"]
                    for a, b in zip(phase5["outputs"][rid],
                                    r0["outputs"][rid]))
        note["bf16_tokens_equal_to_phase5"] = agree
        print(f"sharded [{job} tp {R}] bf16 greedy tokens equal to phase 5's "
              f"one-device run: {agree} of {REQUESTS * NEW_TOKENS} (bf16 "
              "sums over ranks round differently; held in fp32 below)",
              flush=True)
    if job.endswith("fp32"):
        same = r0["outputs"] == r0["one_device"]
        print(f"sharded [{job} tp {R}] greedy tokens of "
              f"{SHARD_FP32['requests']} requests (prompt "
              f"{SHARD_FP32['prompt_len']}, {SHARD_FP32['max_new']} new) "
              f"equal to the one-device model's (tp 1): {same} "
              f"{'ok' if same else 'MISMATCH'}", flush=True)
        if not same:
            fail(f"{job}: tokens at tp {R} differ from one device's")
    if "recomputed" in r0:
        rec = r0["recomputed"]
        same = all(torch.equal(ids, rec[layer][r][0]) and
                   torch.equal(valid, rec[layer][r][1])
                   for r, p in enumerate(per)
                   for layer, (ids, valid) in enumerate(p["routes"])) and \
            all(len(p["routes"]) == len(rec) for p in per)
        drops = sum(int((~v).sum()) for p in per for _, v in p["routes"])
        total = sum(v.numel() for p in per for _, v in p["routes"])
        print(f"sharded [{job} tp {R}] routing: {len(rec)} MoE layers x {R} "
              f"ranks, {total} assignments, {drops} dropped (capacity from "
              f"each rank's {PROMPT_LEN // R} tokens); equal to rank 0's "
              f"recomputation: {same} {'ok' if same else 'MISMATCH'}",
              flush=True)
        if not same:
            fail(f"{job}: a rank's routing differs from the recomputation")
        note["routing_equal"] = same
        note["dropped"] = drops
    pre, dec = r0["step_collectives"]["prefill"], \
        r0["step_collectives"]["decode"]
    print(json.dumps({"sharded": {
        "job": job, "arch": arch, "family": family, "ranks": R,
        "layers": r0["layers"], "d_model": r0["d_model"],
        "dtype": "fp32" if job.endswith("fp32") else "bf16",
        "requests": requests, "tokens": r0["tokens"],
        "wall_s": r0["wall_s"], "tokens_per_s": r0["tokens_per_s"],
        "ttft_p50_ms": r0["ttft_p50_ms"],
        "prefill_ms_p50": r0["prefill_ms_p50"],
        "decode_ms_p50": r0["decode_ms_p50"],
        "peak_mem_bytes_by_rank": [p["peak_mem_bytes"] for p in per],
        "launches_rank0": r0["launches"], "expected_launches": expected,
        "prefill_collectives": pre, "decode_collectives": dec,
        "profile_rank0": r0["profiles"],
        "run_collectives": r0["collectives"]["counts"], **note}}),
        flush=True)


# phase 13: sharded training over R = torch.cuda.device_count() ranks, one
# card each (NCCL), started by the spawn helper, each job through the
# launcher's run_training(mesh=...) inside the rank at full width and depth,
# TRAIN_BATCH x TRAIN_SEQ global tokens a step, TRAIN_STEPS steps, bf16
# compute over an fp32 master and AdamW state sharded FSDP x tp (ZeRO-3);
# the counts are set to 0 in each rank just before its run and read just
# after.  One more step after the run records the step's collectives and,
# on rank 0, a torch.profiler trace.  On one card, a (1, 1) mesh: minicpm-2b
# and mamba2-370m, their losses against phase 10's (the same run without a
# mesh), the collectives of a step against predicted_train_collectives, and
# mamba2-370m's state saved by the sharded save and restored onto no mesh,
# bit-equal.  On four, a (2, 2) mesh: minicpm-2b (18 of 36 heads a rank),
# minitron-4b (5.1 B params: 61 GB of fp32 master, mu and nu, which one card
# cannot hold with a working copy and gradients), mamba2-370m (16 of 32 SSD
# heads a rank), a reduced fp32 minicpm-2b step against one card's, and the
# elastic restore: the reduced fp32 model saved at step 2 on (2, 2),
# restored onto (1, 2) and onto one card, steps 3-4 against the
# uninterrupted run's.
TRAIN_SHARD_JOBS = {1: ("minicpm-2b", "mamba2-370m"),
                    4: ("minicpm-2b", "minitron-4b", "mamba2-370m",
                        "minicpm-2b fp32", "elastic")}
TRAIN_SHARD_MESH = {1: (1, 1), 4: (2, 2)}
#: the reduced fp32 jobs: batch, sequence, steps; fp32 within 1e-5
TRAIN_SMALL = dict(batch=4, seq=64)
TRAIN_SMALL_TOL = 1e-5


def predicted_train_collectives(cfg, B: int, S: int) -> dict:
    """The collectives one bf16 train step of a dense or ssm model issues
    on a (1, 1) mesh (no FSDP gather on one batch rank; every tp
    collective on a group of one): the vocab-parallel embedding's
    all-reduce; per layer the forward's all-reduces (attention and MLP
    outputs; an SSM block's gated-norm squares, fp32, and its output),
    those its recomputation in the backward reaches (all but the layer's
    last: the checkpoint stops recomputing once it has every tensor the
    backward saved), and the backward's all-reduce of each sharded
    sublayer's input gradient (and of the squares'); the head input's
    gradient; the clipping norm's fp32 scalar."""
    act = B * S * cfg.d_model * 2
    sq = B * S * 4
    if cfg.family == "ssm":
        per_layer = [act, sq] + [sq] + [act, sq]
    else:
        per_layer = [act, act] + [act] + [act, act]
    sizes = [act] + per_layer * cfg.num_layers + [act, 4]
    return {"counts": {"all-reduce": len(sizes)},
            "raw_bytes": {"all-reduce": sum(sizes)},
            "wire_bytes": {"all-reduce": 0.0}}


def shard_train(rank: int, mesh: tuple, arch: str, save_dir) -> dict:
    """One training job inside rank ``rank``: launcher's run_training on
    ``mesh`` at full width and depth, kernel launches counted around it,
    then one more step recorded (collectives; rank 0 traced); with
    ``save_dir``, the state saved by the sharded save and restored onto no
    mesh, compared bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.collectives import recording
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.train import run_training
    from repro_torch.train import Checkpointer
    from repro_torch.train.tree import tree_leaves_with_path

    cfg = get_config(arch)
    torch.cuda.synchronize()
    kernel.reset_launch_count()
    ssd_kernel.reset_launch_count()
    res = run_training(cfg, device="cuda", steps=TRAIN_STEPS,
                       batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED,
                       log_every=TRAIN_STEPS, mesh=mesh)
    counts = {"flash": kernel.launch_count(),
              "ssd": ssd_kernel.launch_count()}
    state, step_fn, batch, layout = (res.pop(k) for k in (
        "state", "train_step", "batch", "layout"))
    profiles: dict = {}
    with recording() as stats, rank_profile(rank, profiles, "step"):
        state, _ = step_fn(state, batch)
    out = dict(res, launches=counts, collectives=stats.as_dict(),
               profiles=profiles, layers=cfg.num_layers,
               d_model=cfg.d_model, family=cfg.family,
               params=cfg.param_count())
    if save_dir is not None:
        saved = Checkpointer(save_dir, async_save=False)
        t0 = time.perf_counter()
        saved.save(TRAIN_STEPS + 1, state, layout=layout)
        t_save = time.perf_counter() - t0
        restored, at, _ = saved.restore(state)
        out["restore"] = {
            "step": at, "save_s": t_save,
            "bytes": sum(t.numel() * t.element_size()
                         for _, t in tree_leaves_with_path(state)),
            "equal": all(torch.equal(a, b) for (_, a), (_, b) in zip(
                tree_leaves_with_path(restored),
                tree_leaves_with_path(state)))}
        del restored
    del state, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def small_batches(cfg, steps: int, dev) -> list:
    from repro_torch.data import SyntheticTokens
    src = SyntheticTokens(TRAIN_SMALL["seq"], TRAIN_SMALL["batch"],
                          cfg.vocab_size, seed=SEED)
    return [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in src.next().items()} for _ in range(steps)]


def small_env(mesh: tuple, dev):
    from repro_torch.launch.mesh import env_for_mesh, make_host_mesh
    m = make_host_mesh(*mesh, device_type="cuda") if mesh else None
    return env_for_mesh(m, dev, compute_dtype=torch.float32)


def shard_train_fp32(rank: int, mesh: tuple) -> dict:
    """The reduced minicpm-2b's fp32 step on ``mesh`` against the one-card
    step (on this rank's card, no mesh) from the same draw and batch: the
    gap of the loss and of every param, mu and nu element of the rank's
    shard, a param's less ``first_step_slack`` of the two steps' mu (the
    elements it widens past TRAIN_SMALL_TOL counted, with the largest
    one-card |G| among them and the widest slack)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, MeshLayout, init_train_state,
                                   make_train_step)
    from repro_torch.distributed.sharding import take
    from repro_torch.train.tree import tree_leaves_with_path
    dev = torch.device("cuda", rank)
    cfg = get_config("minicpm-2b").reduced()
    api = get_model(cfg)
    opt = AdamWConfig(warmup=1, total_steps=10)
    batch = small_batches(cfg, 1, dev)[0]
    out = {}
    for name, mesh_ in (("mesh", mesh), ("one", None)):
        env = small_env(mesh_, dev)
        state = init_train_state(api, torch.Generator(device=dev)
                                 .manual_seed(SEED), opt, device=dev,
                                 env=env if mesh_ else None)
        out[name] = make_train_step(api, env, opt)(state, batch)
        if mesh_:
            layout = MeshLayout.of(cfg, env)
    (mine, m_mesh), (whole, m_one) = out["mesh"], out["one"]
    gaps = {"loss": abs(float(m_mesh["loss"]) - float(m_one["loss"]))}
    one_mu = dict(tree_leaves_with_path(whole.opt.mu))
    mesh_mu = dict(tree_leaves_with_path(mine.opt.mu))
    wide = {"n": 0, "g": 0.0, "slack": 0.0}
    for part, a_tree, b_tree in (("params", mine.params, whole.params),
                                 ("mu", mine.opt.mu, whole.opt.mu),
                                 ("nu", mine.opt.nu, whole.opt.nu)):
        b_all = dict(tree_leaves_with_path(b_tree))
        worst = 0.0
        for path, a in tree_leaves_with_path(a_tree):
            index = layout.rules[path].index
            gap = (a - take(b_all[path], index)).abs()
            if part == "params":
                mu_one = take(one_mu[path], index)
                slack = first_step_slack(mesh_mu[path], mu_one, opt)
                over = slack > TRAIN_SMALL_TOL
                if over.any():
                    wide["n"] += int(over.sum())
                    wide["g"] = max(wide["g"], float(
                        (mu_one / (1 - opt.b1)).abs()[over].max()))
                    wide["slack"] = max(wide["slack"], float(slack.max()))
                gap = gap - slack
            worst = max(worst, float(gap.max()) if gap.numel() else 0.0)
        gaps[part] = worst
    return {"gaps": gaps, "widened": wide}


def elastic_run(rank: int, mesh, ckpt_dir: str, save: bool) -> dict:
    """The elastic restore's runs of the reduced fp32 minicpm-2b: with
    ``save``, steps 1-2 on ``mesh``, the sharded save at step 2, then the
    uninterrupted steps 3-4; else the checkpoint restored onto ``mesh``
    (None: one card, no mesh) and steps 3-4.  Returns steps 3-4's
    losses."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import (AdamWConfig, Checkpointer,
                                   checkpoint_layout, init_train_state,
                                   make_train_step)
    dev = torch.device("cuda", rank)
    cfg = get_config("minicpm-2b").reduced()
    api = get_model(cfg)
    opt = AdamWConfig(warmup=1, total_steps=10)
    env = small_env(mesh, dev)
    batches = small_batches(cfg, 4, dev)
    step = make_train_step(api, env, opt)
    layout = checkpoint_layout(api, env, opt)
    state = init_train_state(api, torch.Generator(device=dev).manual_seed(
        SEED if save else SEED + 1), opt, device=dev,
        env=env if mesh else None)
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    if save:
        for b in batches[:2]:
            state, _ = step(state, b)
        ckpt.save(2, state, layout=layout)
    else:
        state, at, _ = ckpt.restore(
            state, sharding_fn=(lambda k, leaf: layout(k, leaf)[1])
            if layout else None)
        assert at == 2
    losses = []
    for b in batches[2:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": losses}


def train_shard_rank(rank: int, R: int, jobs: tuple, work: str) -> dict:
    """Rank ``rank`` of phase 13: each job in turn, in one NCCL world."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = TRAIN_SHARD_MESH[R]
    out = {}
    for job in jobs:
        if job == "elastic":
            out[job] = elastic_run(rank, mesh, os.path.join(work, "elastic"),
                                   True)
        elif job.endswith(" fp32"):
            out[job] = shard_train_fp32(rank, mesh)
        else:
            save = (os.path.join(work, "restore") if R == 1 and
                    job == "mamba2-370m" else None)
            out[job] = shard_train(rank, mesh, job, save)
        torch.distributed.barrier()
    return out


def train_sharded_phase(phase10_losses: dict) -> dict:
    """Phase 13; returns each kernel's launches (all ranks) by job."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.distributed.spawn import spawn
    R = torch.cuda.device_count()
    R = R if R in TRAIN_SHARD_MESH else 1
    jobs = TRAIN_SHARD_JOBS[R]
    skipped = sorted(set(TRAIN_SHARD_JOBS[4]) - set(jobs))
    print(f"sharded training: ranks {R} (NCCL, one card a rank) on a "
          f"{TRAIN_SHARD_MESH[R]} (data, model) mesh; runs {', '.join(jobs)}"
          + (f"; not run for want of 4 cards: {', '.join(skipped)}"
             if skipped else ""), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    build = HERE / "build"
    build.mkdir(exist_ok=True)
    launches = {"flash": {}, "ssd": {}}
    with tempfile.TemporaryDirectory(dir=build) as work:
        t0 = time.perf_counter()
        ranks = spawn(train_shard_rank, R, args=(R, jobs, work),
                      device="cuda", timeout=900)
        print(f"sharded training: {R} ranks ran in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for job in jobs:
            per = [r[job] for r in ranks]
            if job == "elastic":
                elastic_check(per, work)
            elif job.endswith(" fp32"):
                gaps = {k: max(p["gaps"][k] for p in per)
                        for k in per[0]["gaps"]}
                wide = {"elements": sum(p["widened"]["n"] for p in per),
                        "largest_one_card_G": max(p["widened"]["g"]
                                                  for p in per),
                        "widest_slack": max(p["widened"]["slack"]
                                            for p in per)}
                ok = max(gaps.values()) <= TRAIN_SMALL_TOL
                print(f"train sharded [{job} reduced, {TRAIN_SHARD_MESH[R]}"
                      f" vs one card, one step, batch {TRAIN_SMALL['batch']}"
                      f" x {TRAIN_SMALL['seq']}]: largest gaps over the "
                      f"ranks {gaps} (tol {TRAIN_SMALL_TOL:g}; a param's "
                      f"gap less what the two steps' gradient difference "
                      f"moves AdamW's first step by, first_step_slack; "
                      f"elements whose slack exceeds the tol: {wide}) "
                      f"{'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    fail(f"{job}: the sharded step disagrees with one card's")
            else:
                train_shard_check(job, per, R, phase10_losses, launches)
    return launches


def elastic_check(per: list, work: str) -> None:
    """Restore the (2, 2) run's step-2 checkpoint onto (1, 2) and onto one
    card; steps 3-4 against the uninterrupted run's."""
    from repro_torch.distributed.spawn import spawn
    want = per[0]["losses"]
    src = os.path.join(work, "elastic")
    got = {}
    for name, mesh in (("(1, 2)", (1, 2)), ("one card", None)):
        d = os.path.join(work, f"elastic-{len(got)}")
        shutil.copytree(src, d)
        if mesh:
            got[name] = spawn(elastic_run, 2, args=(mesh, d, False),
                              device="cuda", timeout=300)[0]["losses"]
        else:
            got[name] = elastic_run(0, None, d, False)["losses"]
    gap = max(abs(a - b) for ls in got.values() for a, b in zip(ls, want))
    ok = gap <= TRAIN_SMALL_TOL and all(len(v) == 2 for v in got.values())
    print(f"train elastic restore [minicpm-2b reduced fp32, saved at step 2 "
          f"on (2, 2)]: steps 3-4 losses uninterrupted {want}, " +
          ", ".join(f"restored onto {k} {v}" for k, v in got.items()) +
          f"; largest gap {gap:.3g} (tol {TRAIN_SMALL_TOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("an elastic restore does not resume the uninterrupted run")


def train_shard_check(job: str, per: list, R: int, phase10_losses: dict,
                      launches: dict) -> None:
    from repro_torch.configs import get_config
    r0 = per[0]
    cfg = get_config(job)
    per_step = {"flash": 2 * (0 if cfg.family == "ssm" else cfg.num_layers),
                "ssd": 2 * (cfg.num_layers if cfg.family == "ssm" else 0)}
    expected = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    for p in per:
        if p["launches"] != expected:
            fail(f"{job}: a rank launched {p['launches']}, expected "
                 f"{expected}")
        if not all(np.isfinite(p["losses"])):
            fail(f"{job}: a loss is not finite: {p['losses']}")
        if p["losses"] != r0["losses"]:
            fail(f"{job}: the ranks' losses differ")
        if not p["peak_mem_bytes"] < CARD_BYTES:
            fail(f"{job}: a rank's peak memory {p['peak_mem_bytes']} is not "
                 f"under {CARD_BYTES:.0f}")
    for name in ("flash", "ssd"):
        launches[name][f"{job} {TRAIN_SHARD_MESH[R]}"] = sum(
            p["launches"][name] for p in per)
    note: dict = {}
    if R == 1:
        want = predicted_train_collectives(cfg, TRAIN_BATCH, TRAIN_SEQ)
        got = r0["collectives"]
        ok = got["counts"] == want["counts"] and \
            got["raw_bytes"] == want["raw_bytes"] and \
            got["wire_bytes"] == want["wire_bytes"]
        print(f"train sharded [{job} (1, 1)] collectives a step "
              f"{got['counts']} {got['raw_bytes']} B vs predicted "
              f"{want['counts']} {want['raw_bytes']} B "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{job}: a step's collectives {got} != predicted {want}")
        note["collectives_predicted"] = True
        ref = phase10_losses.get(job)
        first = next((i for i, (a, b) in enumerate(zip(r0["losses"], ref))
                      if a != b), None)
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref))
        ok = first != 0 and rel <= RESUME_TOL and len(ref) == TRAIN_STEPS
        print(f"train sharded [{job} (1, 1)] losses vs phase 10's (no mesh):"
              f" {r0['losses']} vs {ref}; bit-equal: {first is None}"
              + ("" if first is None else
                 f"; first difference at step {first + 1}, "
                 f"{abs(r0['losses'][first] - ref[first]):.3g} (the "
                 f"embedding's backward adds by atomics on the card, so two "
                 f"runs differ from the first update on)")
              + f"; largest relative gap {rel:.3g} (tol {RESUME_TOL:g}; the "
              f"first step's loss bit-equal) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"{job}: the (1, 1) mesh's losses disagree with phase 10's")
        note["losses_bit_equal_to_phase10"] = first is None
        note["first_loss_difference_step"] = None if first is None \
            else first + 1
    elif job in phase10_losses:
        # the same global batches and draw as phase 10's one-card run; the
        # mesh sums each product over tp shards and each gradient over the
        # batch ranks in another order, so bf16 rounding parts the two from
        # the first step on: held to RESUME_TOL, phase 10e's bound for two
        # bf16 runs of one model
        ref = phase10_losses[job]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref))
        ok = rel <= RESUME_TOL and len(ref) == len(r0["losses"])
        print(f"train sharded [{job} {TRAIN_SHARD_MESH[R]}] losses vs phase "
              f"10's (one card, no mesh): {r0['losses']} vs {ref}; largest "
              f"relative gap {rel:.3g} (tol {RESUME_TOL:g}, bf16) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{job}: the {TRAIN_SHARD_MESH[R]} mesh's losses disagree "
                 f"with phase 10's")
        note["loss_rel_gap_to_phase10"] = rel
    if "restore" in r0:
        rs = r0["restore"]
        print(f"train sharded [{job} (1, 1)] sharded save of {rs['bytes']} B"
              f" ({rs['save_s']:.3f} s) restored onto no mesh bit-equal: "
              f"{rs['equal']} {'ok' if rs['equal'] else 'MISMATCH'}",
              flush=True)
        if not rs["equal"]:
            fail(f"{job}: the sharded save does not restore bit for bit")
        note["restore_bit_equal"] = rs["equal"]
    coll = r0["collectives"]
    print(json.dumps({"train_sharded": {
        "job": job, "arch": cfg.name, "family": cfg.family, "ranks": R,
        "mesh": list(TRAIN_SHARD_MESH[R]), "layers": r0["layers"],
        "d_model": r0["d_model"], "params": r0["params"],
        "dtype": "bf16 compute, fp32 master and AdamW, FSDP x tp",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": r0["steps"],
        "step_ms_p50": r0["step_ms_p50"], "step_ms": r0["step_ms"],
        "tokens_per_s": r0["tokens_per_s"], "wall_s": r0["wall_s"],
        "peak_mem_bytes_by_rank": [p["peak_mem_bytes"] for p in per],
        "collectives_per_step": {k: coll[k] for k in (
            "counts", "raw_bytes", "wire_bytes", "total_raw_bytes",
            "total_wire_bytes")},
        "flash_launches_by_rank": [p["launches"]["flash"] for p in per],
        "ssd_launches_by_rank": [p["launches"]["ssd"] for p in per],
        "expected_launches_per_rank": expected,
        "loss_first": r0["losses"][0], "loss_last": r0["losses"][-1],
        "profile_rank0": r0["profiles"], **note}}), flush=True)


DRYRUN_CELLS = (["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh",
                 "single", "--no-calibrate"],
                ["--arch", "minicpm-2b", "--shape", "train_4k", "--mesh",
                 "single"])


def dryrun_phase() -> None:
    """The dry run in process, on meta tensors under a fake process group:
    the reference's slow test's cell and a training cell."""
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as out:
        for argv in DRYRUN_CELLS:
            t0 = time.perf_counter()
            cells = dryrun.main(argv + ["--out", out])
            c = cells[0]
            if c["status"] != "ok":
                fail(f"the dry run's cell {argv} failed: {c}")
            ok = (c["chips"] == 256
                  and c["cost"]["flops_per_device"] > 0
                  and c["memory"]["total_per_device"] > 0)
            print(f"dryrun [{' '.join(argv)}]: {c['status']}, {c.get('chips')}"
                  f" chips, {c['cost']['flops_per_device']:.4g} FLOP and "
                  f"{c['cost']['bytes_per_device']:.4g} B a device, memory "
                  f"{c['memory']['total_per_device']} B, roofline "
                  f"{c['roofline']['dominant']} on {c['hardware']}, "
                  f"{time.perf_counter() - t0:.1f} s "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"the dry run's cell {argv} failed: {c}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.moe_grouped import kernel as moe_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_reference
    from repro_torch.kernels.stream_ops import kernel as stream_kernel
    from repro_torch.kernels.sweep_scan import kernel as sweep_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    clock = [time.perf_counter()] * 2

    def phase_time(label: str) -> None:
        """Prints the wall seconds since the last call and since the start."""
        now = time.perf_counter()
        print(f"phase time [{label}]: {now - clock[1]:.1f} s (script at "
              f"{now - clock[0]:.1f} s)", flush=True)
        clock[1] = now

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
    sources = {"flash_fwd.cu": kernel.build, "ssd_fwd.cu": ssd_kernel.build,
               "moe_grouped.cu": moe_kernel.build,
               "decode_attn.cu": da_kernel.build,
               "sweep_scan.cu": sweep_kernel.build,
               "stream_ops.cu": stream_kernel.build,
               "chain_probe.cu": build_chain_probe}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = {name: pool.submit(fn) for name, fn in sources.items()}
        records = {name: f.result() for name, f in builds.items()}
    hmma, port_kernels = {}, set()
    for name, rec in records.items():
        print(f"build: {name} in {rec['seconds']:.2f} s -> {rec['path']}")
        if name == "chain_probe.cu":      # measurement only (phase 9a)
            continue
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
    phase_time("1-2 device, build")

    # 3a. flash kernel vs plain ---------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(B, Sq, Skv, H, K, hd, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((B, Sq, H, hd), (B, Skv, K, hd),
                                   (B, Skv, K, hd)))

    def plain(q, k, v, q_offset, causal=True):
        return reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   q_offset=q_offset).transpose(1, 2)

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
        # the other served models' shapes, each at the serving prompt
        ("whisper_decoder", 1, PROMPT_LEN, PROMPT_LEN, 20, 20, 64,
         torch.bfloat16, 0),
        ("phi3v_hd96", 1, PROMPT_LEN, PROMPT_LEN, 32, 32, 96,
         torch.bfloat16, 0),
        ("kimi_hd112_gqa8", 1, PROMPT_LEN, PROMPT_LEN, 64, 8, 112,
         torch.bfloat16, 0),
        ("qwen25_gqa5", 1, PROMPT_LEN, PROMPT_LEN, 40, 8, 128,
         torch.bfloat16, 0),
        ("minitron_gqa3", 1, PROMPT_LEN, PROMPT_LEN, 24, 8, 128,
         torch.bfloat16, 0),
        ("qwen2_72b_gqa8", 1, PROMPT_LEN, PROMPT_LEN, 64, 8, 128,
         torch.bfloat16, 0),
        ("moonshot_mha", 1, PROMPT_LEN, PROMPT_LEN, 16, 16, 128,
         torch.bfloat16, 0),
        # one rank's local heads at tp 4 (phase 12)
        ("minicpm_tp4_rank", 1, PROMPT_LEN, PROMPT_LEN, 9, 9, 64,
         torch.bfloat16, 0),
        ("qwen2_72b_tp4_rank", 1, PROMPT_LEN, PROMPT_LEN, 16, 2, 128,
         torch.bfloat16, 0),
        ("moonshot_tp4_rank", 1, PROMPT_LEN, PROMPT_LEN, 4, 4, 128,
         torch.bfloat16, 0),
        # one rank's batch and heads on phase 13's (2, 2) training mesh:
        # minicpm-2b's 18 of 36 heads, minitron-4b's 12 of 24 query and 4
        # of 8 KV heads, 2 of the 4 sequences
        ("minicpm_2x2_rank", 2, TRAIN_SEQ, TRAIN_SEQ, 18, 18, 64,
         torch.bfloat16, 0),
        ("minitron_2x2_rank", 2, TRAIN_SEQ, TRAIN_SEQ, 12, 4, 128,
         torch.bfloat16, 0),
    ]
    errors = {}

    def check(name, out, ref, tol, desc):
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool(torch.isfinite(out).all()) and out.shape == ref.shape and \
            bool((diff <= tol + tol * ref.float().abs()).all())
        errors[name] = err
        print(f"kernel vs plain [{name}] {desc}: max_abs_err {err:.3g} "
              f"(tol {tol:g} abs + rel) {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            fail(f"flash kernel disagrees with the plain version on {name}")

    for name, B, Sq, Skv, H, K, hd, dtype, off in cases:
        q, k, v = qkv(B, Sq, Skv, H, K, hd, dtype)
        q_offset = torch.full((B,), off, dtype=torch.int32, device=dev)
        out = ops.flash_attention(q, k, v, q_offset=q_offset)
        torch.cuda.synchronize()
        check(name, out, plain(q, k, v, q_offset),
              1e-5 if off and dtype == torch.float32 else TOLS[dtype],
              f"B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} "
              f"{str(dtype)[6:]} q_offset={off}")

    # the non-causal mode's own path: every case through the op with the
    # count set to 0 just before and read just after, then each output
    # against the plain version; the q_offset case also runs at offset 0,
    # which it must equal bit for bit
    nc_start = time.perf_counter()
    noncausal_cases = [
        # name, B, Sq, Skv, H, K, hd, dtype, q_offset
        ("whisper_encoder", 1, 1500, 1500, 20, 20, 64, torch.bfloat16, 0),
        ("whisper_encoder_fp32", 1, 1500, 1500, 20, 20, 64, torch.float32,
         0),
        ("whisper_cross", 1, PROMPT_LEN, 1500, 20, 20, 64, torch.bfloat16, 0),
        ("gqa_noncausal", 2, 200, 200, 8, 2, 128, torch.bfloat16, 0),
        ("ragged_noncausal", 1, 33, 33, 4, 4, 64, torch.bfloat16, 0),
        ("q_offset_noncausal", 2, 96, 256, 4, 4, 64, torch.bfloat16, 160),
    ]
    inputs = {name: (qkv(B, Sq, Skv, H, K, hd, dtype),
                     torch.full((B,), off, dtype=torch.int32, device=dev))
              for name, B, Sq, Skv, H, K, hd, dtype, off in noncausal_cases}
    kernel.reset_launch_count()
    outs = {name: ops.flash_attention(*x, q_offset=o, causal=False)
            for name, (x, o) in inputs.items()}
    x, o = inputs["q_offset_noncausal"]
    offset0 = ops.flash_attention(*x, q_offset=torch.zeros_like(o),
                                  causal=False)
    torch.cuda.synchronize()
    noncausal_launches = kernel.launch_count()
    if noncausal_launches != len(noncausal_cases) + 1:
        fail(f"the non-causal path launched flash {noncausal_launches} "
             f"times, not {len(noncausal_cases) + 1}")
    for name, B, Sq, Skv, H, K, hd, dtype, off in noncausal_cases:
        (q, k, v), q_offset = inputs[name]
        check(name, outs[name], plain(q, k, v, q_offset, causal=False),
              TOLS[dtype],
              f"B={B} Sq={Sq} Skv={Skv} H={H} K={K} hd={hd} "
              f"{str(dtype)[6:]} q_offset={off} non-causal")
    same = torch.equal(outs["q_offset_noncausal"], offset0)
    print(f"kernel non-causal [q_offset 160 vs 0]: outputs equal {same} "
          f"{'ok' if same else 'MISMATCH'}; non-causal launches "
          f"{noncausal_launches}", flush=True)
    if not same:
        fail("the non-causal kernel's output depends on q_offset")
    del inputs, outs, offset0, x, o
    nc_seconds = time.perf_counter() - nc_start

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

    # the non-causal mode at whisper-large-v3's encoder shape: every
    # (query, key) pair is scored, so the FLOPs are not halved
    nc_start = time.perf_counter()
    B, S, H, hd = 1, 1500, 20, 64
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in qkv(B, S, S, H, H, hd, torch.bfloat16))
    fns = {
        "kernel": lambda: kernel.flash_attention_fwd(
            q, k, v, q_offset=zero, causal=False),
        "plain": lambda: reference_attention(q, k, v, causal=False),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=False),
    }
    nc_ev = time_abba(fns, ("plain", "kernel", "library"))
    nc_ms = {n: device_ms(fn)[0] for n, fn in fns.items()}
    nc_flops = 4.0 * B * H * S * S * hd
    nc_bytes = 4 * q.numel() * q.element_size()
    nc_bound_ms, nc_bound_by = bound(nc_flops, nc_bytes)
    print(f"flash non-causal timing at B={B} S={S} H=K={H} hd={hd} bf16 "
          f"(whisper-large-v3's encoder), device ms per call (profiler, 20 "
          f"calls): kernel {nc_ms['kernel']:.6f}  plain {nc_ms['plain']:.6f}"
          f"  library (SDPA, is_causal=False) {nc_ms['library']:.6f}; event "
          f"ms (mean of 2 rounds of 20, ABBA): kernel {nc_ev['kernel']:.6f}  "
          f"plain {nc_ev['plain']:.6f}  library {nc_ev['library']:.6f}; "
          f"bound_ms {nc_bound_ms:.6f} ({nc_bound_by}; {nc_flops:.4g} FLOP, "
          f"{nc_bytes} B)", flush=True)
    nc_seconds += time.perf_counter() - nc_start
    print(f"phase 3a's non-causal checks and timing: {nc_seconds:.1f} s",
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
        # one rank's 8 of mamba2-370m's 32 heads at tp 4 (phase 12)
        ("mamba2_tp4_rank", 1, PROMPT_LEN, 8, 64, 128, 256, torch.bfloat16,
         False),
        # one rank's 2 sequences and 16 of 32 heads on phase 13's (2, 2)
        ("mamba2_2x2_rank", 2, TRAIN_SEQ, 16, 64, 128, 256, torch.bfloat16,
         False),
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

    # 3c. the hybrid_moe kernels at nemotron-3-nano-30b-a3b's widths --------------
    moe_res = hybrid_moe_kernels(dev, gen)

    # 3d. the split-KV decode-attention kernel at the cells' decode shapes ------
    da_res = decode_attention_kernels(dev, gen)
    phase_time("3 kernels vs plain")

    # 4-5. plan, and serve at full width ------------------------------------------
    phase5: dict = {}
    launches = serve_phase(dev, port_kernels, phase5)
    launches["flash"]["noncausal (phase 3a)"] = noncausal_launches
    phase_time("4-5 plan, serve")

    # 6. agreement with the CPU at a small size ---------------------------------
    agreement_phase(dev)
    phase_time("6 agreement")

    # 7. scheduler: the sweep engine and the mapper search -------------------------
    sweep_entry = scheduler_phase(dev)
    phase_time("7 scheduler")

    # 8. fleet: fleet co-simulation and the online controller ----------------------
    fleet = fleet_phase()
    phase_time("8 fleet")
    sweep_entry["launches"] += fleet["launches"]
    sweep_entry["launches_by_path"].update(
        simulate_fleet=fleet["fleet_launches"],
        controller=fleet["controller_launches"])
    sweep_entry["fleet_max_abs_err_vs_plain"] = \
        fleet["fleet_max_abs_err_vs_plain"]
    sweep_entry["fleet_launch_shape"] = fleet["fleet_launch_shape"]

    # 9. stream: the runtime's operator kernels, the chaos day, the
    # recalibration rails and the stream under WallClock ------------------------
    stream_entries, runtime_sweeps = stream_phase(dev)
    phase_time("9 stream")
    sweep_entry["launches"] += runtime_sweeps
    sweep_entry["launches_by_path"]["runtime"] = runtime_sweeps

    # 10. train: the kernels under autograd, minicpm-2b and mamba2-370m at
    # full width and depth, agreement with the CPU, resume -----------------
    phase10_losses: dict = {}
    trained = train_phase(dev, port_kernels, phase10_losses)
    phase_time("10 train")
    for name in ("flash", "ssd"):
        launches[name]["train"] = trained[name]

    # 11. analysis: the static-analysis CLI, prove --simulate on the kernel --
    prove_launches = analysis_phase()
    phase_time("11 analysis")
    sweep_entry["launches"] += prove_launches
    sweep_entry["launches_by_path"]["analysis_prove"] = prove_launches

    # 12. sharded serving over every visible card -----------------------------
    sharded = sharded_phase(phase5)
    phase_time("12 sharded serving")
    for name in ("flash", "ssd"):
        launches[name]["sharded"] = sharded[name]

    # 13. sharded training over every visible card, and the dry run -----------
    train_sharded = train_sharded_phase(phase10_losses)
    for name in ("flash", "ssd"):
        launches[name]["train_sharded"] = train_sharded[name]
    dryrun_phase()
    phase_time("13 sharded training, dry run")

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": launch_total(launches["flash"]),
        "launches_by_path": launches["flash"],
        "max_abs_err": errors["serving"],
        "max_abs_err_by_case": errors,
        "ms": ms["kernel"],
        "kernel_ms": ms["kernel"],
        "event_ms": ev["kernel"],
        "plain_ms": ms["plain"],
        "plain_event_ms": ev["plain"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": ms["library"],
        "library_event_ms": ev["library"],
        "noncausal": {"shape": "B 1, S 1500, H = K = 20, hd 64, bf16",
                      "ms": nc_ms["kernel"], "event_ms": nc_ev["kernel"],
                      "plain_ms": nc_ms["plain"],
                      "plain_event_ms": nc_ev["plain"],
                      "library_ms": nc_ms["library"],
                      "library_event_ms": nc_ev["library"],
                      "bound_ms": nc_bound_ms, "bound_by": nc_bound_by},
        "hmma": hmma["flash_fwd.cu"],
    }, {
        "name": "ssd_scan_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
        "launches": launch_total(launches["ssd"]),
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
    }, {
        "name": "grouped_relu2_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_grouped/csrc/moe_grouped.cu",
        "replaces": None,
        "launches": launch_total(launches["moe"]),
        "launches_by_path": launches["moe"],
        "max_abs_err": moe_res["errors"][f"{MOE_TOKENS[0]} tokens bfloat16"],
        "max_abs_err_by_case": moe_res["errors"],
        "ms": moe_res["ms"][MOE_TOKENS[0]],
        "kernel_ms": moe_res["ms"][MOE_TOKENS[0]],
        "ms_by_tokens": moe_res["ms"],
        "bound_ms": moe_res["bound_ms"][MOE_TOKENS[0]],
        "bound_ms_by_tokens": moe_res["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "hmma": hmma["moe_grouped.cu"],
    }, {
        "name": "decode_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attn.cu",
        "replaces": None,
        "launches": launch_total(launches["decode_attn"]),
        "launches_by_path": launches["decode_attn"],
        "max_abs_err_by_case": da_res["errors"],
        "fp32_max_abs_err_by_shape": da_res["fp32_errors"],
        "ms": da_res["ms"]["minicpm-2b 16 x 4136 full"],
        "kernel_ms_by_case": da_res["ms"],
        "event_ms_by_case": da_res["event_ms"],
        "plain_ms_by_case": da_res["plain_ms"],
        "bound_ms_by_case": da_res["bound_ms"],
        "bound_by": "bytes",
        "library_ms_by_case": da_res["library_ms"],
        "hmma": hmma["decode_attn.cu"],
    }, sweep_entry, *stream_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
