"""int8 error-feedback gradient compression against the reference's
(the cases of ``tests/test_compression.py``).

Quantization and its inverse equal the reference's on the same input; the
residual carries what quantization dropped; and the compressed reduce, two
steps with the residual fed back, matches the reference's under
``shard_map`` at 1 rank (in this process) and at 4 (4 forced host devices
in a subprocess that writes an ``.npz``), the port on gloo ranks.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks as ranks
from repro.compat import AxisType, make_mesh, shard_map
from repro.distributed.compression import ErrorFeedbackCompressor as JaxEF
from repro.distributed.compression import _dequant as jax_dequant
from repro.distributed.compression import _quant as jax_quant
from repro_torch.distributed.compression import (ErrorFeedbackCompressor,
                                                 _dequant, _quant)
from repro_torch.distributed.spawn import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK, STEPS = 32, 2


def _grads(n):
    rng = np.random.default_rng(3)
    return (rng.normal(size=(n, 2, 100)) * np.linspace(0.1, 3.0, 100)
            ).astype(np.float32)


def test_quant_dequant_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 300)).astype(np.float32)
    jq, js = jax_quant(jnp.asarray(x), 64)
    q, s = _quant(torch.from_numpy(x), 64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    deq = _dequant(q, s, 300, 64)
    np.testing.assert_allclose(deq.numpy(),
                               np.asarray(jax_dequant(jq, js, 300, 64)),
                               rtol=1e-6, atol=1e-7)
    # per-block max error <= scale/2 = max|block| / 254
    bound = np.abs(x).max() / 127.0
    assert float((deq - torch.from_numpy(x)).abs().max()) <= bound + 1e-6


def test_error_feedback_accumulates_lost_mass():
    comp = ErrorFeedbackCompressor(block=32)
    g = {"w": torch.full((64,), 1e-4) + torch.linspace(0, 3.0, 64)}
    residual = comp.init_state(g)
    total = torch.zeros(64)
    for _ in range(20):
        qs, ss, residual = comp.compress(g, residual)
        total = total + _dequant(qs["w"], ss["w"], 64, 32)
    np.testing.assert_allclose((total / 20).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=1e-4)


def _jax_reduce(mesh, grads):
    comp = JaxEF(block=BLOCK)
    g = {"w": jnp.asarray(grads.reshape(-1, grads.shape[-1]))}
    state = comp.init_state(g)
    outs = []
    for _ in range(STEPS):
        out, state = shard_map(
            lambda g, r: comp.reduce(g, r, axis_name="dp"), mesh=mesh,
            in_specs=(P("dp"), P("dp")), out_specs=(P(), P("dp")),
            check_vma=False)(g, state)
        outs.append(np.asarray(out["w"]))
    return outs, np.asarray(state["w"])


def _check(port, outs, residual, n):
    for r, res in enumerate(port):
        for got, want in zip(res["out"], outs):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(res["residual"].numpy(),
                                   residual.reshape(n, 2, -1)[r],
                                   rtol=1e-6, atol=1e-6)


def test_reduce_one_rank_matches_reference(tmp_path):
    grads = _grads(1)
    mesh = make_mesh((1,), ("dp",), axis_types=(AxisType.Auto,))
    outs, residual = _jax_reduce(mesh, grads)
    port = spawn(ranks.compressed_reduce, 1, args=(grads, BLOCK, STEPS),
                 device="cpu", threads=1, timeout=120,
                 workdir=str(tmp_path))
    _check(port, outs, residual, 1)
    # within quantization error of the exact mean
    np.testing.assert_allclose(port[0]["out"][0].numpy(), grads[0],
                               atol=float(np.abs(grads).max()) / 100)


def test_reduce_four_ranks_matches_reference(tmp_path):
    grads = _grads(4)
    np.save(tmp_path / "grads.npy", grads)
    script = textwrap.dedent("""
        import os, sys
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, %r)
        sys.path.insert(0, %r)
        import numpy as np
        from repro.compat import AxisType, make_mesh
        import test_torch_compression as t
        mesh = make_mesh((4,), ("dp",), axis_types=(AxisType.Auto,))
        outs, residual = t._jax_reduce(mesh, np.load(%r))
        np.savez(%r, residual=residual, *outs)
        print("COMPRESSION_OK")
    """ % (os.path.join(REPO, "src"), os.path.join(REPO, "tests"),
           str(tmp_path / "grads.npy"), str(tmp_path / "ref.npz")))
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "COMPRESSION_OK" in proc.stdout, \
        proc.stdout[-1500:] + proc.stderr[-1500:]
    ref = np.load(tmp_path / "ref.npz")
    outs = [ref[f"arr_{i}"] for i in range(STEPS)]
    port = spawn(ranks.compressed_reduce, 4, args=(grads, BLOCK, STEPS),
                 device="cpu", threads=1, timeout=120,
                 workdir=str(tmp_path))
    # (the reference dequantizes the summed codes with the ranks' mean
    # scale, so with unequal scales the result is not the exact mean; the
    # port keeps that arithmetic)
    _check(port, outs, ref["residual"], 4)
