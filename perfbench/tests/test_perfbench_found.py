"""Everything a cell needs is found by name in files of its own, and a
later change adds a configuration, a traffic mix, a runner, a reference
and a per-layer metric as new files only."""

import json
import re
import shutil
import subprocess
import sys


from perfbench import bench

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_shape(benchmark):
    assert set(benchmark) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert benchmark["command"] == ["python3", "perfbench/run.py"]
    assert benchmark["paths"] == ["perfbench"]
    assert 1 <= benchmark["run_seconds"] <= 51
    names = [m["name"] for m in benchmark["end_to_end"] + benchmark["per_layer"]]
    names += [c["name"] for c in benchmark["configs"]]
    names += [w["name"] for w in benchmark["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in benchmark["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in benchmark["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(benchmark["workloads"]) <= 24
    assert len(json.dumps(benchmark)) < 64 * 1024


def test_every_cell_is_found_and_reports_its_metrics(benchmark):
    e2e_names = {m["name"] for m in benchmark["end_to_end"]}
    for w in benchmark["workloads"]:
        cell = bench.find_cell(w["name"], benchmark)
        assert cell.chips == w["chips"] == cell.config["chips"]
        reported = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e_names and m["moves"] in reported
        for m in cell.end_to_end + cell.per_layer:
            assert callable(bench.load("metrics", m["name"]).read)
        assert callable(bench.load("runners", cell.config["runner"]).run)
        fam = cell.config["family"]
        for kind in ("reference", "layouts", "work"):
            assert bench.load(kind, fam)
        if cell.mix["loop"] == "open":
            assert cell.mix["rate_per_s"] > 0
        assert cell.own["logit_gap_limit"] > 0


def test_configs_are_the_files_named(benchmark):
    files = [c["file"] for c in benchmark["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in benchmark["workloads"]}
    for c in benchmark["configs"]:
        assert c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        conf = bench.load_json(ROOT / c["file"])
        assert conf["reduced"] == c["reduced"]
        assert conf["chips"] == 1


def test_configs_match_the_program():
    from repro_torch.configs import get_config
    for path in (bench.HERE / "configs").glob("*.json"):
        conf = bench.load_json(path)
        cfg = get_config(conf["model"])
        assert cfg.family == conf["family"]
        for k, v in conf["sizes"].items():
            assert getattr(cfg, k) == v, (path.name, k)


NEW_FILES = {
    "configs/tiny-dense.json": None,         # filled in below
    "traffic/bursty.json": {
        "loop": "open", "rate_per_s": 4.0,
        "prompt": {"dist": "uniform", "min": 8, "max": 16},
        "output": {"dist": "uniform", "min": 2, "max": 4},
        "trace_steps": 2, "sample_tokens": 8},
    "runners/echo_runner.py": (
        '"""A runner that serves nothing."""\n'
        "def run(cell, **kw):\n    return 'echo:' + cell.name\n"),
    "reference/dense2.py": (
        '"""A second dense reference."""\n'
        "from .dense import logits, weight_spec  # noqa: F401\n"),
    "layouts/dense2.py": "from .dense import port_params  # noqa: F401\n",
    "work/dense2.py": "from .dense import prefill_flops  # noqa: F401\n",
    "metrics/answer.count.py": (
        '"""A made-up per-layer metric."""\n'
        "def read(rd):\n    return 42.0\n"),
    "cells/tiny-dense.bursty.json": {"rate_per_s": 9.0,
                                     "logit_gap_limit": 0.5},
}


def test_new_files_alone_add_a_cell(tmp_path, benchmark):
    """In a copy of the harness, a configuration, a mix, a runner, a
    reference with its layout and work, a per-layer metric and a cell's
    own numbers are added as new files; the harness finds them by name."""
    shutil.copytree(bench.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = bench.load_json(bench.HERE / "configs" / "minicpm-2b.json")
    conf.update(model="minicpm-2b", family="dense2", runner="echo_runner")
    files = dict(NEW_FILES)
    files["configs/tiny-dense.json"] = conf
    for rel, body in files.items():
        p = tmp_path / "perfbench" / rel
        p.write_text(body if isinstance(body, str) else json.dumps(body))
    bm = json.loads(json.dumps(benchmark))
    bm["configs"].append({"name": "tiny-dense", "source": "x",
                          "file": "perfbench/configs/tiny-dense.json",
                          "reduced": [], "why": "x"})
    bm["workloads"].append({"name": "tiny-dense.bursty", "config": "tiny-dense",
                            "traffic": "bursty", "chips": 1, "why": "x"})
    bm["per_layer"].append({"name": "answer.count", "unit": "n",
                            "better": "higher", "source": "program_counter",
                            "layer": "engine", "moves": "output_tokens_per_s",
                            "workloads": ["tiny-dense.bursty"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    script = (
        "import json, sys\n"
        "from perfbench import bench\n"
        "assert bench.HERE.parent == bench.ROOT\n"
        "cell = bench.find_cell('tiny-dense.bursty')\n"
        "out = {'rate': cell.mix['rate_per_s'], 'limit': cell.own['logit_gap_limit'],\n"
        "       'per_layer': [m['name'] for m in cell.per_layer],\n"
        "       'run': bench.load('runners', cell.config['runner']).run(cell),\n"
        "       'metric': bench.load('metrics', 'answer.count').read(None),\n"
        "       'ref': bench.load('reference', 'dense2').weight_spec(cell.sizes)[0][0],\n"
        "       'layout': callable(bench.load('layouts', 'dense2').port_params),\n"
        "       'work': bench.load('work', 'dense2').prefill_flops(cell.sizes, 8) > 0}\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env={"PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}",
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"rate": 9.0, "limit": 0.5, "per_layer": ["answer.count"],
                   "run": "echo:tiny-dense.bursty", "metric": 42.0,
                   "ref": "embed", "layout": True, "work": True}
