#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compiles the flash-attention, SSD-scan and sweep kernels from
   their csrc/ with nvcc, all at once; prints each kernel function's registers
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
   same model run on the CPU;
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
   1e-10, field by field.  The kernel is timed by device time (profiler) at the grid sweep
   and the grid search's buckets, beside the plain version's event time on
   the same tensors and the numpy engine's host time; one
   ``{"scheduler": ...}`` line carries it all.

The line before the last is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits 2 at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
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


def sweep_work(structure, caps: np.ndarray, steps: int, s0: int,
               n_samples: int):
    """Least float64 operations and bytes of one sweep launch on this run's
    data, and the operations one thread (one column) does in sequence.
    Per tick and column: 2 per in-edge (multiply, add), 7 per group
    (arrivals, their dt product, the queue add, cap dt, min, subtract, the
    row sum) and a divide per row with groups; per window tick 1 per group
    (served) and 2 per group with cap > 0 (divide, busy add); per sample 4
    per group with cap > 0, 2 per in-edge, an add per row with in-edges and
    the sink maxima.  Bytes: every input read once, every output written
    once."""
    C, G, K = caps.shape
    rows, edges = structure.row_slices, structure.in_edges
    T, E, S, n_out = len(rows), structure.n_edges, structure.n_slots, \
        structure.n_out
    window = max(steps - s0, 0)
    per_column = (steps * (2 * E + 7 * G + sum(hi > lo for lo, hi in rows))
                  + window * G
                  + n_samples * (2 * E + sum(bool(e) for e in edges)
                                 + sum(max(len(r) - 1, 0)
                                       for r in structure.sink_groups)))
    n_pos = int((caps > 0).sum())
    flops = C * K * per_column + (2 * window + 4 * n_samples) * n_pos
    n_sink_rows = sum(len(r) for r in structure.sink_groups)
    nbytes = (8 * C * G * K + 8 * T * K + 12 * C * G + 8 * C * E
              + 4 * (2 * (T + 1) + E + n_out + 1 + n_sink_rows) + 8 * E
              + 8 * C * K * (2 * G + S + T + n_samples * n_out))
    return float(flops), float(nbytes), flops / (C * K)


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


def against_plain(reference, args, kw, kern) -> tuple:
    """Run the plain version on the kernel call's own card tensors and hold
    the kernel's outputs ``kern`` against it field by field: (max abs error,
    all fields within SWEEP_TOL, the plain call's event time in ms)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain = reference(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    err = max((float((k - p).abs().max()) if k.numel() else 0.0
               for k, p in zip(kern, plain)), default=0.0)
    close = all(k.shape == p.shape and torch.allclose(
        k, p, rtol=SWEEP_TOL, atol=SWEEP_TOL) for k, p in zip(kern, plain))
    return err, close, start.elapsed_time(end)


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

    lib = paper_library()
    sims = {}
    for name in sorted(ALL_DAGS):
        s = plan(ALL_DAGS[name](), 100.0, lib, allocator="mba", mapper="sam")
        sims[name] = DataflowSimulator(s.dag, s.allocation, s.mapping, lib)

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
            "max_stable_rate_numpy": msr["numpy"]}
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
              f"{msr['numpy']}) {'ok' if ok else 'MISMATCH'}", flush=True)
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
                print(f"search bucket [{name} @ {omega:g}] C={C} G={G} K={K}: "
                      f"kernel vs plain on the card max_abs_err {err:.3g} "
                      f"(tol {SWEEP_TOL:g} abs + rel) "
                      f"{'ok' if close else 'MISMATCH'}", flush=True)
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
    total, by_kernel = device_ms(lambda: sweep_kernel.sweep_scan_fwd(*args,
                                                                     **kw))
    sweep_ms = sum(v for k, v in by_kernel.items() if "sweep_scan" in k)
    sweep_event_ms = time_ms(lambda: sweep_kernel.sweep_scan_fwd(*args, **kw))
    structure = args[5]
    flops, nbytes, thread_ops = sweep_work(
        structure, args[0].cpu().numpy(), kw["steps"], kw["s0"],
        n_samples_of(kw["steps"], kw["sample_every"]))
    sweep_bound_ms, sweep_bound_by = bound(flops, nbytes, PEAK_FP64)
    bucket_ms, bucket_plain_ms = [], grid_bucket_plain_ms
    for b_args, b_kw, _ in grid_search_calls:
        _, by_k = device_ms(lambda: sweep_kernel.sweep_scan_fwd(*b_args,
                                                                **b_kw),
                            iters=5)
        bucket_ms.append(sum(v for k, v in by_k.items() if "sweep_scan" in k))
    timing = {
        "grid_sweep": {
            "C": 1, "K": len(SWEEP_OMEGAS), "steps": kw["steps"],
            "kernel_ms": sweep_ms, "kernel_event_ms": sweep_event_ms,
            "plain_event_ms": grid_plain_ms, "numpy_host_ms": grid_numpy_ms,
            "bound_ms": sweep_bound_ms, "bound_by": sweep_bound_by,
            "flops": flops, "bytes": nbytes,
            "thread_serial_ops": thread_ops,
            "kernel_ns_per_serial_op": sweep_ms * 1e6 / thread_ops},
        "grid_search_100": {
            "buckets": [int(a[0].shape[0]) for a, _, _ in grid_search_calls],
            "K": int(grid_search_calls[0][0][0].shape[2]),
            "steps": grid_search_calls[0][1]["steps"],
            "kernel_ms_per_bucket": bucket_ms,
            "kernel_ms": sum(bucket_ms),
            "plain_event_ms_per_bucket": bucket_plain_ms,
            "plain_event_ms": sum(bucket_plain_ms),
            "numpy_host_ms": grid_search_numpy_ms}}
    print(f"sweep timing at the grid sweep (C=1, K=50, {kw['steps']} ticks), "
          f"ms: kernel {sweep_ms:.6f} (device, profiler) / "
          f"{sweep_event_ms:.6f} (events); plain on the card "
          f"{grid_plain_ms:.6f} (events, 1 call); numpy engine "
          f"{grid_numpy_ms:.6f} (host); bound_ms {sweep_bound_ms:.6f} "
          f"({sweep_bound_by}; {flops:.4g} FP64 FLOP, {nbytes:.0f} B); "
          f"{thread_ops:.0f} operations in sequence per thread, "
          f"{sweep_ms * 1e6 / thread_ops:.3f} ns each", flush=True)
    print(f"sweep timing at the grid search at 100 t/s (buckets "
          f"{timing['grid_search_100']['buckets']}), ms: kernel "
          f"{sum(bucket_ms):.6f} (device, summed over buckets); plain on the "
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
    from repro_torch.kernels.sweep_scan import kernel as sweep_kernel
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
    sources = {"flash_fwd.cu": kernel, "ssd_fwd.cu": ssd_kernel,
               "sweep_scan.cu": sweep_kernel}
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

    # 7. scheduler: the sweep engine and the mapper search -------------------------
    sweep_entry = scheduler_phase(dev)

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
    }, sweep_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
