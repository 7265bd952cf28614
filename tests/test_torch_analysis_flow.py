"""The port's interprocedural flow engine against the reference's.

The reaching-definition and CFG cases, the RACE210-212 and JAX110-112
projects, the suppression and syntax-error cases and the three
``tests/fixtures/flow`` exemplars of ``tests/test_flow.py`` run through
both packages on the same inputs: findings, as ``(code, severity,
artifact, path, detail)`` tuples, must be equal, and equal to the codes
the reference's test expects.  Then ``analyze_paths`` over ``src/``,
``tests/`` and ``benchmarks/``, each package's project built once."""

import ast
import pathlib
import textwrap

import pytest

from repro.analysis import cfg as ref_cfg
from repro.analysis import flow as ref_flow
from repro.analysis.lint import iter_py_files as ref_iter
from repro_torch.analysis import cfg as port_cfg
from repro_torch.analysis import flow as port_flow
from repro_torch.analysis.lint import iter_py_files as port_iter

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "flow"
PACKAGES = (("ref", ref_flow), ("port", port_flow))


def rows(violations):
    return [(v.code, v.severity.value, v.artifact, v.path, v.detail)
            for v in violations]


# -- CFG / reaching definitions ----------------------------------------------

# (id, function source, the name whose first load is queried)
RD_CASES = [
    ("straight_line", """
        def f():
            x = make()
            use(x)
    """, "x"),
    ("branch_merges_both", """
        def f(cond):
            if cond:
                x = a()
            else:
                x = b()
            use(x)
    """, "x"),
    ("redefinition_kills", """
        def f():
            x = a()
            x = b()
            use(x)
    """, "x"),
    ("loop_back_edge", """
        def f(xs):
            y = a()
            for x in xs:
                use(y)
                y = b()
    """, "y"),
    ("param_is_opaque", """
        def f(x):
            use(x)
    """, "x"),
    ("global_has_no_local_def", """
        def f():
            use(GLOBAL)
    """, "GLOBAL"),
]
RD_EXPECTED = {"straight_line": ["make"], "branch_merges_both": ["a", "b"],
               "redefinition_kills": ["b"], "loop_back_edge": ["a", "b"],
               "param_is_opaque": [None], "global_has_no_local_def": []}


def _may_values(cfg_mod, src, name):
    fn = ast.parse(textwrap.dedent(src)).body[0]
    rd = cfg_mod.ReachingDefs(fn, fn.body,
                              tuple(a.arg for a in fn.args.args))
    load = [n for n in ast.walk(fn) if isinstance(n, ast.Name)
            and n.id == name and isinstance(n.ctx, ast.Load)][0]
    return sorted((None if v is None else v.func.id)
                  for v in rd.may_values(load, name))


@pytest.mark.parametrize("src,name", [c[1:] for c in RD_CASES],
                         ids=[c[0] for c in RD_CASES])
def test_reaching_definitions_match_the_reference(src, name, request):
    port = _may_values(port_cfg, src, name)
    assert port == _may_values(ref_cfg, src, name)
    assert port == RD_EXPECTED[request.node.callspec.id]


def _reachable_blocks(cfg_mod, src):
    fn = ast.parse(textwrap.dedent(src)).body[0]
    cfg = cfg_mod.CFG(fn, fn.body)
    seen, order, work = set(), [], [cfg.entry]
    while work:
        b = work.pop()
        if b.bid in seen:
            continue
        seen.add(b.bid)
        order.append((b.bid, [type(ev).__name__ for ev in b.events],
                      sorted(s.bid for s in b.succ)))
        work.extend(b.succ)
    return order


def test_cfg_while_else_matches_the_reference():
    src = """
        def f(xs):
            while cond():
                step()
            else:
                done()
            after()
    """
    port = _reachable_blocks(port_cfg, src)
    assert port == _reachable_blocks(ref_cfg, src)
    assert len(port) >= 4            # head, body, else, after


# -- seeded projects: one bug per rule, and their clean twins ---------------

# (id, {module: source}, include_suppressed, expected codes): the projects
# of tests/test_flow.py
PROJECTS = [
    ("race210_abba_cycle", {"locks": """
        import threading
        A = threading.Lock()
        B = threading.Lock()
        def ab():
            with A:
                with B:
                    pass
        def ba():
            with B:
                with A:
                    pass
    """}, False, ["RACE210"]),
    ("race210_consistent_order", {"locks": """
        import threading
        A = threading.Lock()
        B = threading.Lock()
        def ab():
            with A:
                with B:
                    pass
        def also_ab():
            with A:
                with B:
                    pass
    """}, False, []),
    ("race211_join_under_lock", {"mod": """
        import threading
        L = threading.Lock()
        def stop(t):
            with L:
                t.join()
    """}, False, ["RACE211"]),
    ("race211_through_callee", {"mod": """
        import threading
        L = threading.Lock()
        def _drain(t):
            t.join()
        def stop(t):
            with L:
                _drain(t)
    """}, False, ["RACE211"]),
    ("race212_reacquire_via_method", {"mod": """
        import threading
        class Box:
            def __init__(self):
                self._lock = threading.Lock()
            def _reset(self):
                with self._lock:
                    pass
            def flush(self):
                with self._lock:
                    self._reset()
    """}, False, ["RACE212"]),
    ("race212_rlock_is_fine", {"mod": """
        import threading
        class Box:
            def __init__(self):
                self._lock = threading.RLock()
            def _reset(self):
                with self._lock:
                    pass
            def flush(self):
                with self._lock:
                    self._reset()
    """}, False, []),
    ("jax110_jit_from_loop_via_helper", {"mod": """
        import jax
        def make_step(fn):
            return jax.jit(fn)
        def train(fns):
            for fn in fns:
                make_step(fn)
    """}, False, ["JAX110"]),
    ("jax110_hoisted", {"mod": """
        import jax
        def make_step(fn):
            return jax.jit(fn)
        def train(fn, xs):
            step = make_step(fn)
            for x in xs:
                step(x)
    """}, False, []),
    ("jax111_traced_value_into_branch", {"mod": """
        import jax.numpy as jnp
        def clamp(v, lo):
            if v > 0:
                return v
            return lo
        def run(x):
            y = jnp.abs(x)
            return clamp(y, 0.0)
    """}, False, ["JAX111"]),
    ("jax111_concrete_arg", {"mod": """
        import jax.numpy as jnp
        def clamp(v, lo):
            if v > 0:
                return v
            return lo
        def run(n):
            return clamp(float(n), 0.0)
    """}, False, []),
    ("jax112_jit_of_factory_closure", {"mod": """
        import jax
        import numpy as np
        def make_kernel(cfg):
            scale = np.asarray(cfg)
            def kernel(x):
                return x * scale
            return kernel
        def build(cfg):
            k = make_kernel(cfg)
            return jax.jit(k)
    """}, False, ["JAX112"]),
    ("jax112_plain_function", {"mod": """
        import jax
        def kernel(x):
            return x * 2
        def build():
            return jax.jit(kernel)
    """}, False, []),
    ("suppression_comment", {"mod": """
        import threading
        L = threading.Lock()
        def stop(t):
            with L:
                t.join()  # lint: ok RACE211 - t never takes L
    """}, False, []),
    ("suppression_comment_included", {"mod": """
        import threading
        L = threading.Lock()
        def stop(t):
            with L:
                t.join()  # lint: ok RACE211 - t never takes L
    """}, True, ["RACE211"]),
    ("syntax_error", {"broken": "def oops(:\n"}, False, ["LINT000"]),
]


@pytest.mark.parametrize("files,include_suppressed,expected",
                         [c[1:] for c in PROJECTS],
                         ids=[c[0] for c in PROJECTS])
def test_flow_project_matches_the_reference(tmp_path, files,
                                            include_suppressed, expected):
    paths = []
    for name, src in files.items():
        p = tmp_path / f"{name}.py"
        p.write_text(textwrap.dedent(src))
        paths.append(str(p))
    found = {name: rows(mod.analyze_paths(
        paths, include_suppressed=include_suppressed))
        for name, mod in PACKAGES}
    assert found["port"] == found["ref"]
    assert sorted(r[0] for r in found["port"]) == expected


FIXTURE_CASES = [("abba_deadlock.py", ["RACE210"]),
                 ("lock_across_join.py", ["RACE211"]),
                 ("hand_over_hand.py", [])]


@pytest.mark.parametrize("fixture,expected", FIXTURE_CASES,
                         ids=[c[0] for c in FIXTURE_CASES])
def test_flow_fixture_matches_the_reference(fixture, expected):
    path = [str(FIXTURES / fixture)]
    port = rows(port_flow.analyze_paths(path))
    assert port == rows(ref_flow.analyze_paths(path))
    assert [r[0] for r in port] == expected
    if fixture == "abba_deadlock.py":
        assert "cycle" in port[0][4]


def test_fixtures_pruned_from_tree_walks_as_in_the_reference():
    tests = [str(REPO / "tests")]
    assert port_iter(tests) == ref_iter(tests)
    assert not any("fixtures" in f for f in port_iter(tests))
    assert len(port_iter([str(FIXTURES)])) == len(ref_iter([str(FIXTURES)]))


def test_flow_catalog_matches_the_reference():
    assert port_flow.FLOW_RULES == ref_flow.FLOW_RULES
    assert port_flow.BLOCKING_ATTRS == ref_flow.BLOCKING_ATTRS


# -- the repository's own trees ---------------------------------------------

TREES = {"src": ["src"], "tests_and_benchmarks": ["tests", "benchmarks"]}


@pytest.fixture(scope="module")
def projects():
    """Each package's project over each tree, built once."""
    return {(pkg, tree): mod.Project(mod.iter_py_files(
        [str(REPO / d) for d in dirs]))
        for tree, dirs in TREES.items() for pkg, mod in PACKAGES}


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("include_suppressed", [False, True],
                         ids=["default", "include_suppressed"])
def test_analyze_repo_tree_matches_the_reference(projects, tree,
                                                 include_suppressed):
    found = {pkg: rows(mod.analyze_project(
        projects[(pkg, tree)], include_suppressed=include_suppressed))
        for pkg, mod in PACKAGES}
    assert found["port"] == found["ref"]
    if not include_suppressed:
        assert found["port"] == []


def test_src_project_resolves_each_package_to_itself(projects):
    """Both packages hold modules of the same suffixes (``analysis.flow``,
    ``core.simulator``): every call the project resolves stays inside the
    caller's package, and the two packages' locks are distinct keys."""
    project = projects[("port", "src")]
    for fid, fi in project.functions.items():
        top = fi.module.filename.split("/src/")[-1].split("/")[0]
        for cs in fi.calls:
            callee = project.functions[cs.callee].module.filename
            assert callee.split("/src/")[-1].split("/")[0] == top, \
                (fid, cs.callee)
    keys = set(project.locks)
    assert "repro_torch.core.simulator._KERNEL_LOCK" in keys
    assert "core.simulator._KERNEL_LOCK" in keys
