"""No module that a run imports has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``repro``, compared whole (``repro_torch`` begins
with ``repro`` and is the program), and ``run.py`` refuses to run
without the CUDA devices its cell asks for, or without the program."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import bench

ROOT = bench.ROOT


def clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(extra)
    return env


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    before = bench.forbidden_modules()
    assert "repro" not in before and "jax" not in before
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in bench.forbidden_modules()


def test_a_run_imports_neither_jax_nor_the_jax_package(tiny_cell):
    """A whole run (tiny, on the CPU) in a fresh process: every module
    it held once its window closed."""
    script = (
        "import json, sys\n"
        "sys.path[:0] = [%r, %r, %r]\n"
        "from conftest import make_tiny_cell\n"
        "from perfbench import bench\n"
        "cell, cfg = make_tiny_cell('minicpm-2b.long-prompt')\n"
        "run = bench.load('runners', 'serve_one_card')\n"
        "out = run.run(cell, seed=5, seconds=1.0, trace=True, device='cpu', cfg=cfg)\n"
        "for fam in ('dense', 'ssm'):\n"
        "    bench.load('reference', fam); bench.load('layouts', fam)\n"
        "for m in ('flash_roofline', 'ssd_roofline', 'prefill_mfu_pct'):\n"
        "    bench.load('metrics', m)\n"
        "import perfbench.sweep, perfbench.control\n"
        "print(json.dumps({'tops': sorted({m.split('.')[0] for m in sys.modules}),\n"
        "                  'forbidden': bench.forbidden_modules()}))\n"
        % (str(ROOT / "perfbench" / "tests"), str(ROOT), str(ROOT / "src")))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          env=clean_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])


def test_run_without_cuda_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "minicpm-2b.long-prompt", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=clean_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the harness."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-370m.long-prompt", "--seed", "3", "--seconds", "1",
         "--trace", "1"], cwd=tmp_path, env=clean_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
