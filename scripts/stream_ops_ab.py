#!/usr/bin/env python3
"""Time two checkouts' stream-operator kernels on one GPU, in turns.

    python3 scripts/stream_ops_ab.py OLD_SRC NEW_SRC [--parts 16,1024]

OLD_SRC and NEW_SRC are ``src`` directories of two checkouts of this
repository (one unpacked with ``git archive`` into an ignored directory,
say).  Each is timed in a process of its own, in the order old, new, new,
old: each of the four wrappers of ``repro_torch.kernels.stream_ops.kernel``
at each part size (SyntheticSource's seeded draw, payloads of 256 bytes),
by ``torch.profiler`` device time and CUDA events over 20 calls (the
helpers of ``chip_smoke.py``) and the host's time a call over
``HOST_CALLS`` calls (``time.perf_counter_ns``, the launches left to
queue), and the digest alone at each of
``DIGEST_PARTS`` (a checkout whose digest refuses the part records
"refused").  Each process builds its checkout's kernels into that
checkout's ``build/``.  Prints one line a process and a JSON summary of
each checkout's mean over its two turns; needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
KERNELS = ("parse_xml", "viete_pi", "rolling_digest", "external_service")
#: calls timed on the host clock for each kernel and part
HOST_CALLS = 2000
#: parts timed for the digest alone, past the former one-block ceiling of
#: 184,320 tuples
DIGEST_PARTS = (200_000,)


def host_us(fn) -> float:
    """us of host time a call of ``fn`` over HOST_CALLS calls."""
    import time
    import torch
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter_ns() - t0) / HOST_CALLS / 1e3
    torch.cuda.synchronize()
    return us


def time_one(src: str, parts) -> dict:
    """{kernel: {B: (device ms, event ms, host us) or "refused"}} of the
    checkout at ``src``."""
    sys.path.insert(0, str(pathlib.Path(src).resolve()))
    sys.path.insert(1, str(REPO))
    import numpy as np
    import torch
    from chip_smoke import device_ms, time_ms
    from repro_torch.kernels.stream_ops import kernel

    kernel.build()
    dev = torch.device("cuda", 0)
    out = {}
    jobs = [(b, KERNELS) for b in parts]
    jobs += [(b, ("rolling_digest",)) for b in DIGEST_PARTS]
    for B, names in jobs:
        rng = np.random.default_rng(B)
        payload = torch.from_numpy(rng.integers(
            32, 127, size=(B, 256), dtype=np.uint8)).to(dev)
        value = torch.from_numpy(rng.random(B, dtype=np.float32)).to(dev)
        calls = {"parse_xml": lambda: kernel.parse_xml_fwd(payload),
                 "viete_pi": lambda: kernel.viete_pi_fwd(value),
                 "rolling_digest": lambda: kernel.rolling_digest_fwd(value),
                 "external_service":
                     lambda: kernel.external_service_fwd(value)}
        for name in names:
            try:
                calls[name]()
            except ValueError:            # a part this checkout refuses
                out.setdefault(name, {})[B] = "refused"
                continue
            d_ms, _ = device_ms(calls[name], required=False)
            out.setdefault(name, {})[B] = (d_ms, time_ms(calls[name]),
                                           host_us(calls[name]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_src")
    ap.add_argument("new_src")
    ap.add_argument("--parts", default="16,1024")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    parts = [int(b) for b in args.parts.split(",")]
    if args.one:
        print(json.dumps(time_one(args.one, parts)), flush=True)
        return 0
    runs = {"old": [], "new": []}
    for label in ("old", "new", "new", "old"):
        src = args.old_src if label == "old" else args.new_src
        proc = subprocess.run(
            [sys.executable, __file__, args.old_src, args.new_src,
             "--parts", args.parts, "--one", src],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[label].append(got)
        print(f"{label} ({src}): " + "; ".join(
            f"{k} B={b} " + (v if v == "refused" else
                             f"device {v[0]} ms, events {v[1]:.7f} ms, "
                             f"host {v[2]:.3f} us")
            for k, by_b in got.items() for b, v in by_b.items()), flush=True)
    summary = {}
    for label, turns in runs.items():
        for name, by_b in turns[0].items():
            for b in by_b:
                pairs = [t[name][b] for t in turns]
                if "refused" in pairs:
                    summary.setdefault(label, {}).setdefault(name, {})[b] = \
                        "refused"
                    continue
                dev = [p[0] for p in pairs if p[0] is not None]
                summary.setdefault(label, {}).setdefault(name, {})[b] = {
                    "device_ms": sum(dev) / len(dev) if dev else None,
                    "event_ms": sum(p[1] for p in pairs) / len(pairs),
                    "host_us": sum(p[2] for p in pairs) / len(pairs)}
    print(json.dumps({"stream_ops_ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
