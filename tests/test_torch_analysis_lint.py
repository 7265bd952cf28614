"""The port's codebase lint against the reference's, finding for finding.

Every ``lint_source`` case of ``tests/test_analysis.py`` (JAX101-104,
RACE201-202, the suppression forms, LINT000/LINT001) runs through both
packages on the same source; the findings, as ``(code, severity,
artifact, path, detail)`` tuples, must be equal, and equal to the codes
the reference's test expects.  Then ``lint_paths`` over the whole of
``src/`` (both packages' sources), once per package."""

import pathlib

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint as port_lint

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def rows(violations):
    return [(v.code, v.severity.value, v.artifact, v.path, v.detail)
            for v in violations]


# (id, source, include_suppressed, expected codes): the sources of
# tests/test_analysis.py's lint tests, each with what that test expects
CASES = [
    ("jax101_bad",
     "import jax\n"
     "def f(h, xs):\n"
     "    for x in xs:\n"
     "        y = jax.jit(h)\n", False, ["JAX101"]),
    ("jax101_good",
     "import jax\n"
     "def f(h, xs):\n"
     "    g = jax.jit(h)\n"
     "    for x in xs:\n"
     "        y = g(x)\n", False, []),
    ("jax101_nested_def_in_loop",
     "import jax\n"
     "def f(hs):\n"
     "    outs = []\n"
     "    for h in hs:\n"
     "        def make(h=h):\n"
     "            return jax.jit(h)\n"
     "        outs.append(make)\n", False, []),
    ("jax102_bad", "import jax\ny = jax.jit(f)(x)\n", False, ["JAX102"]),
    ("jax102_good", "import jax\ng = jax.jit(f)\ny = g(x)\n", False, []),
    ("jax102_inline_vmap", "import jax\ny = jax.vmap(f)(x)\n", False, []),
    ("jax103_bad", "import jax.numpy as jnp\nif jnp.any(x > 0):\n    y = 1\n",
     False, ["JAX103"]),
    ("jax103_good", "if n > 0:\n    y = 1\n", False, []),
    ("jax104_bad",
     "import jax\nimport numpy as np\n"
     "def make(p):\n"
     "    frac = np.asarray(p)\n"
     "    def kernel(x):\n"
     "        return x * frac\n"
     "    return jax.jit(kernel)\n", False, ["JAX104"]),
    ("jax104_good",
     "import jax\nimport numpy as np\n"
     "def make(p):\n"
     "    frac = np.asarray(p)\n"
     "    def kernel(x, frac):\n"
     "        return x * frac\n"
     "    return jax.jit(kernel)\n", False, []),
    ("race201_bad",
     "_CACHE = {}\n"
     "def get(key, build):\n"
     "    if key not in _CACHE:\n"
     "        _CACHE[key] = build(key)\n"
     "    return _CACHE[key]\n", False, ["RACE201"]),
    ("race201_good",
     "import threading\n"
     "_CACHE = {}\n"
     "_LOCK = threading.Lock()\n"
     "def get(key, build):\n"
     "    with _LOCK:\n"
     "        if key not in _CACHE:\n"
     "            _CACHE[key] = build(key)\n"
     "        return _CACHE[key]\n", False, []),
    ("race202_bad", "def f(x, acc=[]):\n    acc.append(x)\n", False,
     ["RACE202"]),
    ("race202_good", "def f(x, acc=None):\n    acc = acc or []\n", False, []),
    ("suppressed",
     "import jax\ny = jax.jit(f)(x)  # lint: ok JAX102 - one-shot tool\n",
     False, []),
    ("suppressed_included",
     "import jax\ny = jax.jit(f)(x)  # lint: ok JAX102 - one-shot tool\n",
     True, ["JAX102"]),
    ("suppression_wrong_code",
     "import jax\ny = jax.jit(f)(x)  # lint: ok JAX101 - nope\n", False,
     ["JAX102"]),
    ("suppression_comma_list",
     "import jax\n"
     "def f(x, acc=[]):  # lint: ok RACE202, JAX102 - shared comment\n"
     "    return jax.jit(g)(x), acc  # lint: ok JAX102, RACE202 - both\n",
     False, []),
    ("suppression_comma_list_included",
     "import jax\n"
     "def f(x, acc=[]):  # lint: ok RACE202, JAX102 - shared comment\n"
     "    return jax.jit(g)(x), acc  # lint: ok JAX102, RACE202 - both\n",
     True, ["JAX102", "RACE202"]),
    ("suppression_wildcard",
     "import jax\ny = jax.jit(f)(x)  # lint: ok * - generated code\n", False,
     []),
    ("suppression_wildcard_included",
     "import jax\ny = jax.jit(f)(x)  # lint: ok * - generated code\n", True,
     ["JAX102"]),
    ("suppression_unknown_code", "x = 1  # lint: ok JAX999 - no such rule\n",
     False, ["LINT001"]),
    ("suppression_flow_code", "x = 1  # lint: ok RACE210 - flow code\n",
     False, []),
    ("syntax_error", "def broken(:\n", False, ["LINT000"]),
]


@pytest.mark.parametrize("source,include_suppressed,expected",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_lint_source_matches_the_reference(source, include_suppressed,
                                           expected):
    ref = ref_lint.lint_source(source, include_suppressed=include_suppressed)
    port = port_lint.lint_source(source,
                                 include_suppressed=include_suppressed)
    assert rows(port) == rows(ref)
    assert sorted({v.code for v in port}) == expected


def _catalog(rules):
    """Each rule's code, name and its doc's first line (what ``--list-rules``
    and the SARIF rule table print)."""
    return [(r.code, r.name, r.doc.strip().splitlines()[0]) for r in rules]


def test_rule_catalog_matches_the_reference():
    assert _catalog(port_lint.RULES) == _catalog(ref_lint.RULES)
    assert port_lint.KNOWN_CODES == ref_lint.KNOWN_CODES


@pytest.fixture(scope="module")
def src_findings():
    """``lint_paths`` over ``src/`` by each package, with and without the
    suppressed findings."""
    return {name: {inc: rows(mod.lint_paths([str(SRC)],
                                            include_suppressed=inc))
                   for inc in (False, True)}
            for name, mod in (("ref", ref_lint), ("port", port_lint))}


@pytest.mark.parametrize("include_suppressed", [False, True],
                         ids=["default", "include_suppressed"])
def test_lint_paths_over_src_matches_the_reference(src_findings,
                                                   include_suppressed):
    port = src_findings["port"][include_suppressed]
    assert port == src_findings["ref"][include_suppressed]
    if include_suppressed:
        assert port, "the sources' suppressed findings come back"
    else:
        assert port == []
