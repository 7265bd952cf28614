"""Find an open-loop cell's knee: the highest offered rate at which the
requests waiting at the window's end are no more than at its start.

    python3 perfbench/sweep.py --workload minicpm-2b.long-prompt \\
        --seed 7 --rates 2,3,4,5 --lead 10 --seconds 30      # on the card
    python3 perfbench/sweep.py --workload minicpm-2b.long-prompt --plan

One process builds the cell once and offers each rate in turn: the
cell's mix at that rate for ``--lead`` seconds, the count of requests
waiting (``ServeEngine.pending``) then, ``--seconds`` more, the count
again; then it steps, sending nothing, until the engine is empty (a
fresh engine where a minute does not do).  It prints one JSON line a
rate and, last, the knee.  ``--plan`` prints instead, on the CPU, what
the serving planner (``repro_torch.serve.plan_serving``'s performance
models on ``H100_SXM``) predicts one card sustains on the same mix.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import bench, reduce, traffic  # noqa: E402


def mean_lengths(cell: bench.Cell, n: int = 4096):
    return (float(traffic.lengths(cell.mix["prompt"], n).mean()),
            float(traffic.lengths(cell.mix["output"], n).mean()))


def plan(cell: bench.Cell) -> dict:
    """The planner's capacity of one card on the cell's mix: a request
    costs its prefill (batch 1, as the engine runs it) and its share of
    decode steps over every slot, at the roofline model's rates."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.roofline import (H100_SXM,
                                                  stage_tokens_per_sec)
    cfg = get_config(cell.config["model"])
    P, G = mean_lengths(cell)
    slots = int(cell.config["slots"])
    pre = stage_tokens_per_sec(cfg, chips=1, batch=1, context=int(P),
                               stage="prefill", hardware=H100_SXM)
    dec = stage_tokens_per_sec(cfg, chips=1, batch=slots,
                               context=int(P + G), stage="decode",
                               hardware=H100_SXM)
    per_request = P / pre + G / dec
    return {"workload": cell.name, "mean_prompt": P, "mean_output": G,
            "prefill_tokens_per_s": pre, "decode_tokens_per_s": dec,
            "planned_capacity_per_s": 1.0 / per_request,
            "hardware": H100_SXM.name}


def offer(run, sys_, cell, seed, rate, lead, seconds):
    """One rate: returns its point."""
    import torch
    mix = {**cell.mix, "rate_per_s": rate}
    n = traffic.pool_size(mix, lead + seconds, int(cell.config["slots"]))
    tr = traffic.generate(mix, seed, cell.sizes["vocab_size"], n)
    loop = run.Loop(sys_, tr, False, lead + seconds)
    eng = sys_.engine
    loop.t_open = time.perf_counter()
    marks, i = {}, 0
    reqs = tr.requests
    end = loop.t_open + lead + seconds
    while True:
        now = time.perf_counter()
        for key, at in (("start", lead), ("end", lead + seconds)):
            if key not in marks and now >= loop.t_open + at:
                marks[key] = len(eng.pending) + sum(
                    1 for r in reqs[i:] if loop.t_open + r.due <= now)
        if now >= end:
            break
        while i < len(reqs) and loop.t_open + reqs[i].due <= now:
            loop.send(reqs[i], loop.t_open + reqs[i].due)
            i += 1
        if eng.has_work():
            loop.step()
        else:
            time.sleep(max(0.0, min(loop.t_open + reqs[i].due
                                    if i < len(reqs) else end, end) - now))
    emitted = loop.emitted()
    firsts = [e.first_token_at - d for _, d, _, e in loop.sent
              if e.first_token_at is not None]
    stop = time.perf_counter() + 60.0
    while eng.has_work() and time.perf_counter() < stop:
        eng.step()
    fresh = eng.has_work()
    torch.cuda.synchronize()
    return {"rate_per_s": rate, "waiting_start": marks["start"],
            "waiting_end": marks["end"], "sent": len(loop.sent),
            "output_tokens_per_s": emitted / (lead + seconds),
            "ttft_p90_ms_of_first_tokens": (
                reduce.percentile(firsts, 90) * 1e3 if firsts else None),
            "drained": not fresh}, fresh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="")
    ap.add_argument("--lead", type=float, default=10.0)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--plan", action="store_true")
    args = ap.parse_args(argv)
    bench.cache_dirs()
    cell = bench.find_cell(args.workload)
    if args.plan:
        print(json.dumps(plan(cell)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    run = bench.load("runners", cell.config["runner"])
    sys_ = run.build(cell, args.seed, "cuda")
    run.warm_up(sys_, args.seed)
    points = []
    for rate in [float(r) for r in args.rates.split(",")]:
        point, fresh = offer(run, sys_, cell, args.seed, rate, args.lead,
                             args.seconds)
        points.append(point)
        print(json.dumps({"point": point,
                          "device": torch.cuda.get_device_name()}),
              flush=True)
        if fresh:       # the backlog did not drain: start again empty
            sys_.engine = None
            sys_ = run.build(cell, args.seed, "cuda")
            run.warm_up(sys_, args.seed)
    held = [p["rate_per_s"] for p in points
            if p["waiting_end"] <= p["waiting_start"]]
    print(json.dumps({"knee_per_s": max(held) if held else None,
                      "workload": cell.name}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
