"""Runs a command and prints each line of its standard output prefixed
with the wall seconds since the start, so that two runs of a script that
prints no phase times (an older ``chip_smoke.py``) can be set side by side
phase by phase:

    python3 scripts/line_times.py -- python3 chip_smoke.py

Exits with the command's exit code; its standard error passes through.
"""

import os
import subprocess
import sys
import time


def main(argv: list) -> int:
    cmd = argv[argv.index("--") + 1:] if "--" in argv else argv
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    for line in proc.stdout:
        sys.stdout.write(f"[{time.perf_counter() - t0:9.1f}] {line}")
        sys.stdout.flush()
    return proc.wait()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
