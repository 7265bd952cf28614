"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU runs."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.models import default_env
from repro_torch.models import transformer
from repro_torch.configs import get_config

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_launcher_loads_neither_jax_nor_repro():
    """The launchers (serving, training, the dry run) and the analysis CLI
    import neither JAX nor the reference, and importing them initialises
    no process group (the dry run makes its fake one in ``run_cell``)."""
    code = ("import sys, repro_torch.launch.serve, repro_torch.serve, "
            "repro_torch.analysis.__main__, repro_torch.launch.train, "
            "repro_torch.launch.dryrun;"
            "import torch.distributed as dist;"
            "assert not dist.is_initialized();"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_a_device_refuse_the_cpu(monkeypatch):
    """Without a card the entry points raise rather than run on the CPU:
    the serving path's, the streaming runtime's ``StreamExecutor``,
    ``LiveFleet`` and ``SyntheticSource`` (which would otherwise run their
    operators' plain versions), and the analysis CLI's ``prove --simulate``
    (the sweep's); the CLI's ``lint`` touches no device and still runs."""
    import repro_torch.core as core
    import repro_torch.runtime as rt
    from repro_torch.analysis.__main__ import main as analysis_main

    lib = core.paper_library()
    sched = core.plan(core.diamond_dag(), 80.0, lib, allocator="mba",
                      mapper="sam")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init(get_config("minicpm-2b"), torch.Generator())
    assert default_env("cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.StreamExecutor(sched, lib, clock=rt.VirtualClock())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.LiveFleet(core.FleetController(lib, budget_slots=12))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.SyntheticSource(100.0)
    ex = rt.StreamExecutor(sched, lib, clock=rt.VirtualClock(), device="cpu")
    assert {str(d) for d in ex.slot_device.values()} == {"cpu"}
    assert rt.LiveFleet(core.FleetController(lib, budget_slots=12),
                        device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analysis_main(["prove", "--simulate"])
    assert analysis_main(["prove", "--simulate", "--device", "cpu"]) == 0
    assert analysis_main(["lint", str(REPO / "src" / "repro_torch")]) == 0
