"""``python -m repro_torch.analysis`` against ``python -m repro.analysis``.

Both CLIs' ``main`` run in process on the same arguments; their standard
output and exit codes must be equal: ``--list-rules``, ``lint``/``flow``
with ``--json``, ``--sarif`` (apart from the tool's name), the path-first
form, ``--verify-smoke``, ``prove`` at the CLI's defaults and at 120 slots
/ 3000 t/s, with ``--simulate`` on the port's ``--device cpu`` (the sweep
kernel's plain version) against the reference's numpy co-simulation, and
the usage errors' exit 2."""

import json
import pathlib

import pytest

from repro.analysis.__main__ import main as ref_main
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.kernels.sweep_scan import kernel as sweep_kernel

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "flow"

#: a source with one finding of each body-local rule and a dead suppression
BAD_SOURCE = (
    "import jax\n"
    "import jax.numpy as jnp\n"
    "import numpy as np\n"
    "_CACHE = {}\n"
    "def f(h, xs, acc=[]):\n"
    "    for x in xs:\n"
    "        y = jax.jit(h)\n"
    "    if jnp.any(y > 0):\n"
    "        _CACHE[0] = jax.jit(h)(xs)\n"
    "    return acc  # lint: ok JAX999 - no such rule\n"
    "def make(p):\n"
    "    frac = np.asarray(p)\n"
    "    def kernel(x):\n"
    "        return x * frac\n"
    "    return jax.jit(kernel)\n")


def run(main, argv, capsys):
    capsys.readouterr()
    code = main(list(argv))
    out = capsys.readouterr().out
    return code, out


def both(argv, capsys, port_argv=None):
    """(code, stdout) of the reference and of the port."""
    ref = run(ref_main, argv, capsys)
    port = run(port_main, argv if port_argv is None else port_argv, capsys)
    return ref, port


@pytest.fixture
def bad_tree(tmp_path):
    (tmp_path / "bad.py").write_text(BAD_SOURCE)
    (tmp_path / "fine.py").write_text("def g(x):\n    return x + 1\n")
    return tmp_path


def test_list_rules_matches_the_reference(capsys):
    ref, port = both(["--list-rules"], capsys)
    assert port == ref
    assert ref[0] == 0 and "RATE309" in ref[1] and "JAX112" in ref[1]


CLI_CASES = {
    "lint_json": (["lint", "{tree}", "--json"], 1),
    "lint_text": (["lint", "{tree}"], 1),
    "lint_path_first": (["{tree}"], 1),
    "lint_include_suppressed": (["lint", "{tree}", "--include-suppressed",
                                 "--json"], 1),
    "flow_json_fixtures": (["flow", "{fixtures}", "--json"], 1),
    "flow_text_fixtures": (["flow", "{fixtures}"], 1),
    "flow_clean_file": (["flow", "{fixtures}/hand_over_hand.py", "--json"],
                        0),
    "lint_src_json_suppressed": (["lint", "{src}", "--json",
                                  "--include-suppressed"], 1),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_findings_output_matches_the_reference(case, bad_tree, capsys):
    argv, code = CLI_CASES[case]
    argv = [a.format(tree=bad_tree, fixtures=FIXTURES, src=REPO / "src")
            for a in argv]
    ref, port = both(argv, capsys)
    assert port == ref
    assert ref[0] == code
    if "--json" in argv:
        doc = json.loads(port[1][:port[1].rindex("}") + 1])
        assert doc["version"] == 2
        assert bool(doc["findings"]) == bool(code)


@pytest.mark.parametrize("command", ["lint", "flow"])
def test_sarif_matches_the_reference_but_for_the_tool_name(command,
                                                           bad_tree,
                                                           tmp_path_factory,
                                                           capsys):
    out = tmp_path_factory.mktemp("sarif")
    target = str(bad_tree if command == "lint" else FIXTURES)
    docs = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        path = out / f"{name}.sarif"
        code, _ = run(main, [command, target, "--sarif", str(path)], capsys)
        assert code == 1
        docs[name] = json.loads(path.read_text())
    assert docs["ref"]["runs"][0]["tool"]["driver"].pop("name") == \
        "repro.analysis"
    assert docs["port"]["runs"][0]["tool"]["driver"].pop("name") == \
        "repro_torch.analysis"
    assert docs["port"] == docs["ref"]
    assert docs["port"]["runs"][0]["results"]


def test_verify_smoke_matches_the_reference(capsys):
    ref, port = both(["--verify-smoke"], capsys)
    assert port == ref == (0, "verify-smoke: clean\n")


PROVE_SETTINGS = {"defaults": [], "120_slots_3000": [
    "--budget-slots", "120", "--max-rate", "3000"]}
#: cells the prover decides on the reference's run, per setting
DECIDED = {"defaults": "27/27", "120_slots_3000": "21/27"}


@pytest.mark.parametrize("setting", list(PROVE_SETTINGS))
def test_prove_matches_the_reference(setting, capsys):
    argv = ["prove", *PROVE_SETTINGS[setting]]
    ref, port = both(argv, capsys)
    assert port == ref
    assert ref[0] == 0
    assert f"prove: {DECIDED[setting]} cells decided" in ref[1]


@pytest.mark.parametrize("setting", list(PROVE_SETTINGS))
def test_prove_simulate_on_the_plain_sweep_matches_the_reference(setting,
                                                                  capsys):
    argv = ["prove", "--simulate", *PROVE_SETTINGS[setting]]
    sweep_kernel.reset_launch_count()
    ref, port = both(argv, capsys, port_argv=argv + ["--device", "cpu"])
    assert port == ref
    assert ref[0] == 0
    assert f"prove: {DECIDED[setting]} cells decided" in ref[1]
    assert "prove: simulate cross-check — 0 mismatch(es) over 27 cells" \
        in ref[1]
    assert sweep_kernel.launch_count() == 0      # the CPU runs no kernel


def test_prove_simulate_json_matches_the_reference(capsys):
    argv = ["prove", "--simulate", "--json"]
    ref, port = both(argv, capsys, port_argv=argv + ["--device", "cpu"])
    assert port == ref
    doc = json.loads(ref[1][ref[1].index("{"):])
    assert doc["version"] == 2 and len(doc["cells"]) == 3


def test_usage_errors_exit_2(tmp_path, capsys):
    broken = tmp_path / "broken.py"
    broken.write_text("def oops(:\n")
    for argv in (["prove", "src/"], ["lint", str(broken)],
                 ["flow", str(broken)], [str(broken)]):
        ref, port = both(argv, capsys)
        assert port == ref and port[0] == 2, argv


def test_core_analysis_alias_matches_the_reference():
    """``repro_torch.core.analysis`` re-exports the analysis layer under the
    name the reference keeps (``repro.core.analysis``), with its
    ``__all__``; importing the core does not import it."""
    import subprocess
    import sys

    import repro.core.analysis as ref_alias
    import repro_torch.analysis as port_analysis
    import repro_torch.core.analysis as port_alias
    assert port_alias.__all__ == ref_alias.__all__
    assert all(getattr(port_alias, n) is getattr(port_analysis, n)
               for n in port_alias.__all__)
    code = ("import sys, repro_torch.core; "
            "assert 'repro_torch.analysis' not in sys.modules; "
            "assert 'repro_torch.core.analysis' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
