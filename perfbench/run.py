"""Run one cell of ``BENCHMARK.json``:

    python3 perfbench/run.py --workload minicpm-2b.long-prompt \\
        --seed 12345 --seconds 51 --trace 0

Prints the result as the last line of standard output (``perfbench/
bench.py``).  Needs the CUDA devices the cell asks for."""

import time

STARTED = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the harness's modules as the package ``perfbench``, never as top-level
# names; the program from the checkout's ``src``
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if pathlib.Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], started=STARTED))
