"""The port's sharding rules against the reference's, on abstract meshes.

``repro_torch.distributed.sharding`` carries the reference's rules over
unchanged; these tests hold them equal on the two production meshes
((16, 16) and (2, 16, 16), no devices needed) for all ten architectures,
with ``serving`` true and false: ``param_spec`` on the reference's own
paths and shapes, ``port_param_spec`` on the port's tree (one dict per
layer, projections (out, in)) against the reference's spec with its layer
entry dropped and its trailing entries swapped where the port's leaf is the
transpose, and ``batch_spec``/``cache_spec`` on the reference's input and
cache shapes.  Then the port's shard of each reduced leaf is the rule's
block wherever the rule splits whole heads, units, rows or experts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.compat import make_abstract_mesh
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jax_sharding
from repro.models import get_model as jax_get_model
from repro.models.api import cache_specs, input_specs
from repro.models.common import Env as JaxEnv
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import Mesh
from repro_torch.launch.mesh import (env_for_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import get_model
from repro_torch.models.convert import reference_last_axis

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _envs(mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = make_abstract_mesh(shape, axes)
    batch = tuple(a for a in axes if a != "model")
    jenv = JaxEnv(mesh=jmesh, batch_axes=batch, tp_axis="model")
    tenv = env_for_mesh(make_production_mesh(multi_pod=mesh_name == "multi"),
                        "cpu")
    return jenv, tenv


def _norm(spec):
    """A spec as a tuple of entries, one-name tuples as the name (the
    reference's ``P`` normalises them so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in tuple(spec))


def _ref_leaves(cfg):
    shapes = jax.eval_shape(jax_get_model(cfg).init, jax.random.PRNGKey(0))
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        out[jax_sharding._path_to_str(path)] = tuple(leaf.shape)
    return out


def _port_leaves(cfg):
    params = get_model(cfg).init(torch.Generator(), device="meta")
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        else:
            out[prefix] = tuple(tree.shape)
    walk(params, "")
    return out


def test_production_meshes_match_the_reference():
    for name, (shape, axes) in MESHES.items():
        mesh = make_production_mesh(multi_pod=name == "multi")
        assert mesh.axis_names == axes
        assert tuple(mesh.shape.values()) == shape
        assert mesh.size == int(np.prod(shape))
    host = make_host_mesh(2, 4)
    assert host.shape == {"data": 2, "model": 4} and host.coords is None
    env = env_for_mesh(make_production_mesh(multi_pod=True), "cpu")
    assert env.batch_axes == ("pod", "data") and env.tp_axis == "model"
    assert (env.dp, env.tp) == (32, 16)
    assert env.tp_entry_if_divisible(8) is None
    assert env.tp_entry_if_divisible(32) == "model"


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch, mesh_name, serving):
    """The copied rules on the reference's paths, and the port's own tree
    through ``port_param_spec``, against the reference's specs."""
    assert arch in JARCHS
    jenv, tenv = _envs(mesh_name)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    ref = _ref_leaves(jcfg)
    for path, shape in ref.items():
        want = _norm(jax_sharding.param_spec(jenv, path, shape,
                                             serving=serving))
        got = _norm(sharding.param_spec(tenv, path, shape, serving=serving))
        assert got == want, (path, got, want)
    port = _port_leaves(tcfg)
    matched = 0
    for path, shape in port.items():
        ref_path, stacked = sharding.reference_path(path)
        ref_shape = ref[ref_path][1:] if stacked else ref[ref_path]
        want = _norm(jax_sharding.param_spec(jenv, ref_path, ref[ref_path],
                                             serving=serving))
        if stacked:
            want = want[1:]
        # transposed leaves show it in their shape; a square one (kimi's
        # wq) by the conversion's own rule
        flipped = len(shape) == 2 and (
            shape != ref_shape if shape != shape[::-1] else
            reference_last_axis(path, torch.empty(shape, device="meta")) == 0)
        if flipped:
            assert shape == ref_shape[::-1], path
            want = want[::-1]
        else:
            assert shape == ref_shape, path
        got = _norm(sharding.port_param_spec(
            tenv, path, shape, num_layers=tcfg.num_layers, serving=serving))
        assert got == want, (path, got, want)
        matched += 1
    assert matched == len(port)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_equal_the_reference(arch, mesh_name):
    jenv, tenv = _envs(mesh_name)
    cfg = jax_get_config(arch)
    for shape_name, shape in SHAPES.items():
        for name, leaf in input_specs(cfg, shape).items():
            assert _norm(sharding.batch_spec(tenv, name, leaf.shape)) == \
                _norm(jax_sharding.batch_spec(jenv, name, leaf.shape))
        if shape.kind != "decode":
            continue
        for name, leaf in cache_specs(cfg, shape, JaxEnv()).items():
            assert _norm(sharding.cache_spec(tenv, name, leaf.shape)) == \
                _norm(jax_sharding.cache_spec(jenv, name, leaf.shape)), name


def test_cache_spec_gqa_kv_fallback_to_seq():
    """K=8 kv heads under tp=16: the cache shards its sequence dim."""
    _, env = _envs("single")
    spec = sharding.cache_spec(env, "k", (64, 128, 32768, 8, 128))
    assert _norm(spec) == _norm(JP(None, ("data",), "model", None, None))


def test_cache_spec_mha_shards_heads():
    _, env = _envs("single")
    spec = sharding.cache_spec(env, "k", (38, 128, 32768, 32, 64))
    assert _norm(spec) == (None, "data", None, "model", None)


def test_cache_spec_long_context_batch1():
    """long_500k: batch 1 -> KV sequence over the data axes."""
    _, env = _envs("single")
    spec = sharding.cache_spec(env, "k", (38, 1, 524288, 32, 64))
    assert _norm(spec) == (None, None, "data", "model", None)


def test_param_specs_shard_the_big_matrices():
    _, env = _envs("single")
    assert _norm(sharding.param_spec(env, "blocks/attn/wq",
                                     (80, 8192, 8192))) == \
        (None, "data", "model")
    # the port's (out, in) wq: the tp entry moves to the rows
    assert _norm(sharding.port_param_spec(env, "blocks/0/attn/wq",
                                          (8192, 8192), num_layers=80)) == \
        ("model", "data")
    assert _norm(sharding.param_spec(env, "embed", (152064, 8192))) == \
        ("model", "data")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["minicpm-2b", "moonshot-v1-16b-a3b",
                                  "whisper-large-v3", "zamba2-1.2b"])
def test_port_shard_is_the_rules_block_where_it_splits_whole_units(arch, tp):
    """Every leaf of a reduced model: the port's shard (``local_index``)
    equals ``local_shard`` of its serving spec, except the leaves the
    port splits by structure (the SSM's concatenated projection and
    conv), which keep whole heads, and the position table it keeps
    whole."""
    cfg = get_config(arch).reduced()
    mesh = Mesh((1, tp), ("data", "model"))
    env = env_for_mesh(mesh, "cpu")
    params = get_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    # split by structure, and whisper's position table, which the rule's
    # "embed$" splits over tp and the port keeps whole (sharding.py)
    structural = ("ssm/in_proj", "ssm/conv_w", "ssm/conv_b", "pos_embed")
    checked = 0
    for r in range(tp):
        coords = {"data": 0, "model": r}

        def walk(tree, prefix):
            nonlocal checked
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{prefix}/{k}" if prefix else k)
                return
            if isinstance(tree, list):
                for i, v in enumerate(tree):
                    walk(v, f"{prefix}/{i}")
                return
            got = sharding.take(tree, sharding.local_index(
                cfg, mesh, prefix, tree.shape, coords))
            if prefix.endswith(structural):
                return
            spec = sharding.port_param_spec(env, prefix, tree.shape,
                                            num_layers=cfg.num_layers,
                                            serving=True)
            want = sharding.local_shard(tree, spec, mesh, coords)
            assert torch.equal(got, want), prefix
            checked += 1
        walk(params, "")
    assert checked > 0


def test_ssm_split_keeps_whole_heads():
    """The head-aligned split of a Mamba2 block: z, x and dt rows of the
    rank's heads and every B and C row."""
    cfg = get_config("mamba2-370m").reduced()
    d_in, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    mesh = Mesh((1, 4), ("data", "model"))
    rows = sharding.local_index(cfg, mesh, "blocks/0/ssm/in_proj",
                                (2 * d_in + 2 * N + H, cfg.d_model),
                                {"data": 0, "model": 1})[0]
    hd, h_l = cfg.ssm_head_dim, H // 4
    chans = torch.arange(h_l * hd, 2 * h_l * hd)
    assert torch.equal(rows, torch.cat([
        chans, d_in + chans, torch.arange(2 * d_in, 2 * d_in + 2 * N),
        2 * d_in + 2 * N + torch.arange(h_l, 2 * h_l)]))


def test_kv_heads_for_gqa_below_the_width():
    # K divides tp: blocks of K / tp
    assert sharding.kv_heads(16, 8, 4, 3, True) == (6, 2)
    # K = 2 under tp 4: ranks 0-1 read KV head 0, ranks 2-3 KV head 1
    assert [sharding.kv_heads(8, 2, 4, r, True) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]
    assert sharding.kv_map(8, 2, 4, 2, True) is None
    # 12 query heads over 4 KV heads at tp 3: rank 0's heads 0-3 read KV
    # heads 0 (three of them) and 1 (one), which no uniform grouping gives
    assert sharding.kv_heads(12, 4, 3, 0, True) == (0, 2)
    assert sharding.kv_map(12, 4, 3, 0, True).tolist() == [0, 0, 0, 1]
    # query heads that replicate read every KV head
    assert sharding.kv_heads(6, 2, 4, 1, False) == (0, 2)


def test_local_shard_blocks_follow_mesh_order():
    mesh = Mesh((2, 2), ("data", "model"))
    x = torch.arange(8).reshape(8, 1)
    got = [sharding.local_shard(x, (("data", "model"),), mesh,
                                mesh.coords_of(r)).flatten().tolist()
           for r in range(4)]
    assert got == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert sharding.local_shard(x, ("model",), mesh,
                                {"data": 1, "model": 1}).flatten().tolist() \
        == [4, 5, 6, 7]


def test_gqa_reduced_variant_is_what_the_rank_tests_run():
    cfg = dataclasses.replace(get_config("qwen2-72b").reduced(),
                              num_kv_heads=2)
    assert cfg.num_heads % 4 == 0 and cfg.num_kv_heads % 4 != 0


def test_training_forward_under_a_mesh_differentiates_to_one_device(
        tmp_path):
    """The forward the port once refused under a mesh with grad on: on a
    (1, 2) mesh of gloo ranks its loss and every gradient leaf (the
    replicated ones completed by ``sharding.reduce_grads``) equal the
    rank's part of the one-device loss and gradients, in fp32."""
    import _torch_ranks as ranks
    from repro_torch.distributed.spawn import spawn
    for res in spawn(ranks.forward_grads, 2, args=(1, 2, "dense"),
                     device="cpu", threads=1, timeout=240,
                     workdir=str(tmp_path)):
        assert res["leaves"] > 10 and res["gap"] <= 1e-5, res
