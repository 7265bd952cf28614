"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

The reference's CLI runs in a subprocess (it forces 512 host devices at
import): its ``--list`` must equal the port's line for line, and its
``model_flops`` the port's for every arch x shape.  The port's rank-0 state
on the production meshes must hold, leaf by leaf, the local shapes of the
reference's ``tree_param_specs`` (its FSDP x tp rules) wherever the port
follows the rule (the structural layouts of ``distributed/sharding.py``
apart).  A small cell runs end to end through ``main`` on meta tensors
under a fake process group of 256 ranks, and the two-depth calibration
reproduces the direct count (the port's layers are a loop, so the direct
count is exact).  Mirrors ``tests/test_dryrun_integration.py`` (whose
cell, mamba2-370m decode_32k, is the end-to-end one here).
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import jax
import pytest
import torch.distributed as dist

from repro.compat import make_abstract_mesh
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.models import get_model as jax_get_model
from repro.models.common import Env as JaxEnv
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import full_shapes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _reference(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ,
                               "PYTHONPATH": os.path.join(REPO, "src")},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def reference():
    out = _reference(
        "import json, sys, contextlib, io\n"
        "import repro.launch.dryrun as d\n"
        "from repro.configs import ARCHS, SHAPES, get_config\n"
        "buf = io.StringIO()\n"
        "sys.argv = ['dryrun', '--list']\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    d.main()\n"
        "flops = {f'{a}/{s}': d.model_flops(get_config(a), SHAPES[s])\n"
        "         for a in ARCHS for s in SHAPES}\n"
        "print(json.dumps({'list': buf.getvalue(), 'flops': flops}))\n")
    return json.loads(out.strip().splitlines()[-1])


def test_list_equals_the_reference(reference, capsys):
    assert dryrun.main(["--list"]) == []
    assert capsys.readouterr().out == reference["list"]
    assert len(reference["list"].splitlines()) == len(ARCHS) * len(SHAPES)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(reference, arch):
    for s, shape in SHAPES.items():
        assert dryrun.model_flops(get_config(arch), shape) == \
            reference["flops"][f"{arch}/{s}"], s


def _structural(cfg, mesh, path, shape):
    """Whether the port's tp split of a leaf follows the structure rather
    than the rule (``distributed/sharding.py``'s notes)."""
    env = sharding._RuleEnv(mesh, (), "model")
    spec = sharding.port_param_spec(env, path, shape, serving=True)
    coords = {a: 0 for a in mesh.axis_names}
    rule = [n // mesh.axis_size(e) if e is not None else n
            for n, e in zip(shape, spec)]
    port = [n if ix is None else len(ix) for n, ix in zip(
        shape, sharding.local_index(cfg, mesh, path, shape, coords))]
    return rule != port


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_rank_state_holds_the_reference_rules_local_shapes(arch, mesh_name):
    """Rank 0's training shard of every leaf (FSDP over the batch axes x
    tp) has the element count of the reference's ``tree_param_specs``
    local shape, but for the structural layouts (SSM ``B``/``C`` rows and
    conv channels, heads or KV heads that do not divide tp, whisper's
    ``pos_embed``), which are listed; so the rank's state bytes are the
    reference's, those leaves apart."""
    shape_, axes = MESHES[mesh_name]
    jmesh = make_abstract_mesh(shape_, axes)
    batch = tuple(a for a in axes if a != "model")
    jenv = JaxEnv(mesh=jmesh, batch_axes=batch, tp_axis="model")
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(jax_get_model(jcfg).init, jax.random.PRNGKey(0))
    specs = jax_sharding.tree_param_specs(jenv, shapes)
    ref_local = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_leaves_with_path(shapes),
            jax.tree_util.tree_leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        key = jax_sharding._path_to_str(path)
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        ref_local[key] = math.prod(
            n // (math.prod(jmesh.shape[a] for a in
                            (e if isinstance(e, tuple) else (e,)))
                  if e is not None else 1)
            for n, e in zip(leaf.shape, entries))
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    coords = {a: 0 for a in mesh.axis_names}
    port, ref, structural = 0, 0, set()
    per_layer = {}
    for path, full in full_shapes(cfg).items():
        index = sharding.local_index(cfg, mesh, path, full, coords,
                                     batch_axes=batch)
        n = math.prod(f if ix is None else len(ix)
                      for f, ix in zip(full, index))
        ref_path, stacked = sharding.reference_path(path)
        if _structural(cfg, mesh, path, full):
            structural.add(ref_path.rsplit("/", 2)[-2] + "/"
                           + ref_path.rsplit("/", 1)[-1]
                           if "/" in ref_path else ref_path)
            continue
        port += n
        per_layer[ref_path] = stacked
    for ref_path, stacked in per_layer.items():
        layers = (cfg.encoder_layers if ref_path.startswith("enc_")
                  else cfg.num_layers) if stacked else 1
        ref += ref_local[ref_path] // (layers if stacked else 1) * layers
    assert port == ref
    for name in structural:
        assert re.fullmatch(r"ssm/(in_proj|conv_w|conv_b)|pos_embed|"
                            r"(attn|self_attn|cross_attn)/(w[qkvo]|b[qkv])",
                            name), name


def test_calibration_reproduces_the_direct_count():
    """cost(L) is affine in depth, and the port's count at depth L is
    direct: the L=1/L=2 extrapolation equals it (a 3-layer minicpm-2b
    train step and a whisper decode step with 3 encoder and 3 decoder
    layers)."""
    for arch, shape, over in (
            ("minicpm-2b", "train_4k", {"num_layers": 3}),
            ("whisper-large-v3", "decode_32k", {"num_layers": 3,
                                                "encoder_layers": 3})):
        cell = dryrun.run_cell(arch, shape, multi_pod=False,
                               cfg_overrides=over)
        assert cell["status"] == "ok", cell.get("traceback")
        cost = cell["cost"]
        for k in ("flops", "bytes"):
            assert cost[f"{k}_per_device_corrected"] == pytest.approx(
                cost[f"{k}_per_device"], rel=1e-12), (arch, k)
        assert cost["coll_per_device_corrected"] == pytest.approx(
            cell["collectives"]["per_device_wire_bytes"], rel=1e-12)
        if shape == "train_4k":
            # args: the rank's fp32 params, mu and nu, the step, the
            # global tokens and labels
            cfg = dataclasses.replace(get_config(arch), **over)
            mesh = make_production_mesh()
            coords = {a: 0 for a in mesh.axis_names}
            n = sum(math.prod(f if ix is None else len(ix) for f, ix in zip(
                full, sharding.local_index(cfg, mesh, path, full, coords,
                                           batch_axes=("data",))))
                for path, full in full_shapes(cfg).items())
            sh = SHAPES[shape]
            assert cell["memory"]["args_bytes"] == \
                3 * 4 * n + 4 + 2 * 8 * sh.global_batch * sh.seq_len


def test_small_cell_end_to_end(tmp_path):
    """The reference's dry-run test cell through ``main``: status ok on 256
    ranks, FLOPs, bytes and memory above zero, the roofline on the H100,
    and no process group left behind."""
    cells = dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                         "--mesh", "single", "--no-calibrate",
                         "--out", str(tmp_path)])
    assert not dist.is_initialized()
    with open(tmp_path / "pod16x16-mamba2-370m-decode_32k.json") as f:
        cell = json.load(f)
    assert cells == [cell]
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["hardware"].startswith("H100")
    assert cell["cost"]["flops_per_device"] > 0
    assert cell["cost"]["bytes_per_device"] > 0
    assert cell["memory"]["total_per_device"] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert cell["collectives"]["counts"]
