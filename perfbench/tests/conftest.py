"""The harness's tests run on the CPU at tiny sizes:

    python -m pytest -q perfbench/tests

``tiny_cell`` builds a cell of ``BENCHMARK.json`` cut to a tiny program
configuration (the program's ``ModelConfig.reduced()``) and tiny
traffic."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import bench  # noqa: E402


def make_tiny_cell(name: str, slots: int = 4):
    from repro_torch.configs import get_config
    bm = bench.load_json(ROOT / "BENCHMARK.json")
    cell = bench.find_cell(name, bm)
    cfg = get_config(cell.config["model"]).reduced()
    sizes = {k: getattr(cfg, k) for k in cell.sizes}
    config = {**cell.config, "sizes": sizes, "slots": slots}
    mix = {**cell.mix, "prompt": {"dist": "lognormal", "median": 24,
                                  "sigma": 0.5, "min": 8, "max": 48},
           "trace_steps": 4, "sample_tokens": 16}
    if mix["loop"] == "open":
        mix.update(rate_per_s=8.0,
                   output={"dist": "uniform", "min": 3, "max": 6})
    else:
        mix.update(output={"dist": "lognormal", "median": 8, "sigma": 0.5,
                           "min": 4, "max": 16})
    cell = bench.Cell(cell.name, 1, config, mix, cell.own, cell.end_to_end,
                      cell.per_layer)
    return cell, cfg


@pytest.fixture
def tiny_cell():
    return make_tiny_cell


@pytest.fixture(scope="session")
def benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
