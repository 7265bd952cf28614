"""Readings for a cell's correctness limit, on the card, in one process:
for each seed, a short window at the cell's own load, then the program's
``logit_gap`` and the control's (the float8 reference in the program's
place, ``perfbench/check.py``) on the same sample.

    python3 perfbench/control.py --workload minicpm-2b.long-prompt \\
        --seconds 20 --seeds 11,12,13

One JSON line a seed: the program's gap and the control's, each judged
by the run's own comparison (``correct``, ``control_correct``) against the
cell's committed limit.  Exits with 1 where the program is not correct
or the control is, on any seed.  The benchmark's own runs never run the
control."""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    bench.cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    run = bench.load("runners", cell.config["runner"])
    held = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run(cell, seed=seed, seconds=args.seconds, trace=False,
                      control=True)
        ctrl = out.control()
        held &= out.correct and not ctrl.correct
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "logit_gap": out.checks["logit_gap"][0],
            "limit": out.checks["logit_gap"][1], "correct": out.correct,
            "control_gap": ctrl.checks["logit_gap"][0],
            "control_correct": ctrl.correct,
            "sampled": out.notes.get("sampled"), "attempted": out.attempted,
            "device": out.device_kind}), flush=True)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
