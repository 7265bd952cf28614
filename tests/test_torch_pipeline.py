"""GPipe over a pipe axis of rank processes against the reference's
``gpipe`` and the sequential oracle (the cases of
``tests/test_pipeline.py``).

One stage: the reference in this process on its one CPU device, the port
on one gloo rank.  Four stages: the reference on 4 forced host devices in a
subprocess that writes an ``.npz``, the port on four gloo ranks, each
holding only its stage's layers; every rank's output matches.  The
schedule issues n_microbatches + n_stages - 1 permutes and one all-reduce
on each rank.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from repro.compat import AxisType, make_mesh
from repro.distributed.pipeline import gpipe, split_stages
from repro_torch.distributed.spawn import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _layer_fn(stage_params, x):
    def body(c, w):
        return jnp.tanh(c @ w), None
    y, _ = jax.lax.scan(body, x, stage_params)
    return y


def _inputs(seed, L, d, n_mb, mb):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(L, d, d)) * 0.3).astype(np.float32)
    x = rng.normal(size=(n_mb, mb, d)).astype(np.float32)
    return ws, x


def _sequential(ws, x):
    ref = x
    for w in ws:
        ref = np.tanh(ref @ w)
    return ref


def _reference_four_stages(tmp_path, ws, x):
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    script = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, %r)
        import jax, jax.numpy as jnp, numpy as np
        from repro.compat import AxisType, make_mesh
        from repro.distributed.pipeline import gpipe, split_stages

        def layer_fn(stage_params, x):
            def body(c, w):
                return jnp.tanh(c @ w), None
            y, _ = jax.lax.scan(body, x, stage_params)
            return y

        d = np.load(%r)
        mesh = make_mesh((4,), ("pipe",), axis_types=(AxisType.Auto,))
        f = gpipe(layer_fn, mesh, pipe_axis="pipe",
                  n_microbatches=d["x"].shape[0])
        y = jax.jit(f)(split_stages(jnp.asarray(d["ws"]), 4),
                       jnp.asarray(d["x"]))
        np.save(%r, np.asarray(y))
        print("PIPELINE_OK")
    """ % (os.path.join(REPO, "src"), str(tmp_path / "in.npz"),
           str(tmp_path / "out.npy")))
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-1500:]
    return np.load(tmp_path / "out.npy")


def test_gpipe_single_stage_matches_reference(tmp_path):
    ws, x = _inputs(0, 4, 8, 3, 5)
    mesh = make_mesh((1,), ("pipe",), axis_types=(AxisType.Auto,))
    f = gpipe(_layer_fn, mesh, pipe_axis="pipe", n_microbatches=3)
    want = np.asarray(f(split_stages(jnp.asarray(ws), 1), jnp.asarray(x)))
    (got,) = spawn(ranks.pipeline, 1, args=(ws, x, 3), device="cpu",
                   threads=1, timeout=120, workdir=str(tmp_path))
    np.testing.assert_allclose(got["y"].numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["y"].numpy(), _sequential(ws, x),
                               rtol=TOL, atol=TOL)
    # a permute onto itself moves nothing
    assert got["stats"]["counts"] == {"collective-permute": 3,
                                      "all-reduce": 1}
    assert got["stats"]["wire_bytes"]["collective-permute"] == 0.0


def test_gpipe_four_stages_match_reference(tmp_path):
    ws, x = _inputs(1, 8, 16, 6, 4)
    want = _reference_four_stages(tmp_path, ws, x)
    out = spawn(ranks.pipeline, 4, args=(ws, x, 6), device="cpu",
                threads=1, timeout=120, workdir=str(tmp_path))
    for r in out:
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["y"].numpy(), _sequential(ws, x),
                                   rtol=TOL, atol=TOL)
        mb_bytes = 4 * 16 * 4
        assert r["stats"]["counts"] == {"collective-permute": 6 + 4 - 1,
                                        "all-reduce": 1}
        assert r["stats"]["wire_bytes"]["collective-permute"] == \
            pytest.approx(9 * mb_bytes)


def test_split_stages_groups_contiguous_layers():
    import torch
    from repro_torch.distributed.pipeline import split_stages as port_split
    ws = torch.arange(8 * 2).reshape(8, 2)
    staged = port_split({"w": ws, "b": [ws]}, 4)
    assert tuple(staged["w"].shape) == (4, 2, 2)
    assert staged["w"][1].tolist() == [[4, 5], [6, 7]]
    assert tuple(staged["b"][0].shape) == (4, 2, 2)
    with pytest.raises(AssertionError):
        port_split(ws, 3)
