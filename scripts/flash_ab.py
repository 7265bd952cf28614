#!/usr/bin/env python3
"""Time two checkouts' flash-attention kernels on one GPU, in turns.

    python3 scripts/flash_ab.py OLD_SRC NEW_SRC

OLD_SRC and NEW_SRC are ``src`` directories of two checkouts of this
repository (one unpacked with ``git archive`` into an ignored directory,
say).  Each is timed in a process of its own, in the order old, new, new,
old: ``repro_torch.kernels.flash_attention.kernel.flash_attention_fwd`` at
each of ``SHAPES`` (causal, seeded inputs in the kernel's layout), and at
``NONCAUSAL_SHAPES`` with ``causal=False`` where the checkout's wrapper
takes that argument, by ``torch.profiler`` device time and CUDA events
over 20 calls (the helpers of ``chip_smoke.py``).  Each process builds its
checkout's kernel into that checkout's ``build/`` and prints the ptxas
report of each kernel function (registers, spill stores and loads).
Prints one line a process and a JSON summary of each checkout's mean over
its two turns; needs CUDA.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
#: (name, B, S, H, K, hd, dtype): the serving prompt of minicpm-2b,
#: qwen2.5-32b's GQA group of 5 and minicpm's shape in fp32
SHAPES = (("minicpm_bf16", 1, 1024, 36, 36, 64, "bfloat16"),
          ("qwen25_gqa5_bf16", 1, 1024, 40, 8, 128, "bfloat16"),
          ("minicpm_fp32", 1, 1024, 36, 36, 64, "float32"))
#: whisper-large-v3's encoder self-attention
NONCAUSAL_SHAPES = (("whisper_encoder_bf16", 1, 1500, 20, 20, 64,
                     "bfloat16"),)


def time_one(src: str) -> dict:
    """{"ptxas": {function: [regs, spill st, spill ld]}, "times": {case:
    [device ms, event ms]}} of the checkout at ``src``."""
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    sys.path.insert(1, str(REPO))
    import torch
    from chip_smoke import device_ms, ptxas_report, time_ms
    from repro_torch.kernels.flash_attention import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    rec = kernel.build()
    dev = torch.device("cuda", 0)
    takes_causal = "causal" in inspect.signature(
        kernel.flash_attention_fwd).parameters
    jobs = [(s, True) for s in SHAPES]
    if takes_causal:
        jobs += [(s, False) for s in NONCAUSAL_SHAPES]
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for (name, B, S, H, K, hd, dtype), causal in jobs:
        dt = getattr(torch, dtype)
        q = torch.randn((B, H, S, hd), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, K, S, hd), generator=gen, device=dev).to(dt)
                for _ in range(2))
        kw = {} if causal else {"causal": False}

        def call():
            return kernel.flash_attention_fwd(q, k, v, **kw)
        d_ms, _ = device_ms(call, required=False)
        times[name] = [d_ms, time_ms(call)]
    return {"ptxas": {fn: list(r) for fn, r in
                      ptxas_report(str(rec["ptxas"])).items()},
            "times": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_src")
    ap.add_argument("new_src")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one)), flush=True)
        return 0
    runs = {"old": [], "new": []}
    for label in ("old", "new", "new", "old"):
        src = args.old_src if label == "old" else args.new_src
        proc = subprocess.run(
            [sys.executable, __file__, args.old_src, args.new_src,
             "--one", src], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(got)
        print(f"{label} ({src}): " + "; ".join(
            f"{case} device {d} ms, events {e:.7f} ms"
            for case, (d, e) in got["times"].items()), flush=True)
        if len(runs[label]) == 1:
            for fn, (regs, st, ld) in sorted(got["ptxas"].items()):
                print(f"  {label} ptxas: {fn}: {regs} registers, {st} bytes "
                      f"spill stores, {ld} bytes spill loads", flush=True)
    summary = {}
    for label, turns in runs.items():
        for case in turns[0]["times"]:
            pairs = [t["times"][case] for t in turns]
            dev = [p[0] for p in pairs if p[0] is not None]
            summary.setdefault(label, {})[case] = {
                "device_ms": sum(dev) / len(dev) if dev else None,
                "event_ms": sum(p[1] for p in pairs) / len(pairs)}
    print(json.dumps({"flash_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
