"""The port's train step sharded over ranks, against the reference's
sharded step and the port's own one-device step.

The reference runs in one subprocess (``tests/_torch_train_shard_ref.py``:
4 forced host devices, its ``make_train_step`` jitted under
``env_for_mesh`` on (2, 2), (1, 4) and (4, 1) meshes, fp32, one step from
one state and global batch); the port runs the same state and batch on the
same meshes as gloo rank processes on the CPU (``distributed/spawn.py``,
one thread a rank, the bodies in ``tests/_torch_ranks.py``).  The port's
state is FSDP x tensor-parallel (``distributed/sharding.py``'s training
layout, ZeRO-3: params, ``mu`` and ``nu`` all sharded).  Per rank and
family: the loss, every new param, ``mu`` and ``nu`` leaf within 1e-5 of
the rank's part of the reference's (a new param also within what AdamW's
first step moves it by for the two steps' gradients' rounding difference,
``_torch_ranks.first_step_slack``: up to 2 lr where the gradient is zero
but for rounding, as a key bias's is), and of the port's
one-device step too but for MoE at tp > 1, whose capacity is per shard
(as the reference's ``shard_map`` computes it).  The dense case adds
``microbatches=2`` and the int8 second moment at a block-aligned (16) and
an unaligned (48) shard; the sharded quantizer is held bit for bit against
the reference's on the same input.  Mirrors the reference's sharded
training in ``tests/test_dryrun_integration.py`` (compiled there, run
here) and ``tests/test_train.py``'s step tests.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro_torch.distributed.sharding import kv_heads
from repro_torch.distributed.spawn import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = ranks.TRAIN_TOL
MESHES = ((2, 2), (1, 4), (4, 1))
CASES = sorted(ranks.CASES)
RANK_TIMEOUT = 300


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_shard_ref")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_train_shard_ref.py"),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    state = {"dir": str(out), "proc": proc, "done": False}
    yield state
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _ready(reference):
    if not reference["done"]:
        stdout, stderr = reference["proc"].communicate(timeout=900)
        assert reference["proc"].returncode == 0 and \
            "TRAIN_SHARD_REF_OK" in stdout, stdout[-2000:] + stderr[-3000:]
        reference["done"] = True
    return reference["dir"]


def _spawn(tmp_path_factory, fn, nprocs, *args):
    return spawn(fn, nprocs, args=args, device="cpu", threads=1,
                 timeout=RANK_TIMEOUT,
                 workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def knobs(tmp_path_factory, reference):
    """Started while the reference computes: gradients under each Env
    knob against the default's on (2, 2)."""
    runs = [("dense", [("dots", {"remat_policy": "dots"}),
                       ("seq_shard", {"seq_shard_activations": True})]),
            ("moe", [("seq_shard", {"seq_shard_activations": True})]),
            ("hybrid", [("seq_shard", {"seq_shard_activations": True}),
                        ("dots", {"remat_policy": "dots"})]),
            ("audio", [("attn_q_chunk", {"attn_q_chunk": 4}),
                       ("dots", {"remat_policy": "dots"})])]
    return _spawn(tmp_path_factory, ranks.knob_grads, 4, 2, 2, runs)


@pytest.fixture(scope="module")
def parity(tmp_path_factory, reference, knobs):
    ref_dir = _ready(reference)
    return {(d, m): _spawn(tmp_path_factory, ranks.train_parity, d * m,
                           ref_dir, d, m, CASES)
            for d, m in MESHES}


def _runs(parity, mesh, key):
    results = parity[mesh]
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in results) == [(d, m) for d in range(mesh[0])
                                        for m in range(mesh[1])]
    return [(r["coords"], r[key]) for r in results]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_train_step_matches_the_reference(parity, mesh, case):
    for coords, res in _runs(parity, mesh, f"{case}/{mesh[0]}x{mesh[1]}"):
        gaps = {k: res[k] for k in ("loss", "params", "mu", "nu")}
        print(f"{coords}: params widened past {TOL:g} by the first step's "
              f"slack {res['params_slack']}")
        assert max(gaps.values()) <= TOL, (coords, gaps)


#: MoE under tp routes each shard's tokens with its own capacity, as the
#: reference's ``shard_map`` does, so it is held to the reference only
ONE_DEVICE = [(m, c) for m in MESHES for c in CASES
              if not (c == "moe" and m[1] > 1)]


@pytest.mark.parametrize("mesh,case", ONE_DEVICE,
                         ids=[f"{m[0]}x{m[1]}-{c}" for m, c in ONE_DEVICE])
def test_sharded_train_step_matches_one_device(parity, mesh, case):
    for coords, res in _runs(parity, mesh, f"{case}/{mesh[0]}x{mesh[1]}"):
        gaps = {k: res[f"one_{k}"] for k in ("loss", "params", "mu", "nu")}
        print(f"{coords}: params widened past {TOL:g} by the first step's "
              f"slack {res['one_params_slack']}")
        assert max(gaps.values()) <= TOL, (coords, gaps)


def test_microbatches_under_a_mesh_match_the_reference(parity):
    for coords, res in _runs(parity, (2, 2), "dense/mb2"):
        gaps = {k: res[k] for k in ("loss", "params", "mu", "nu")}
        assert max(gaps.values()) <= TOL, (coords, gaps)


@pytest.mark.parametrize("tag", ["q16", "q48"], ids=["aligned", "unaligned"])
def test_int8_second_moment_under_a_mesh_matches_the_reference(parity, tag):
    """Blocks of 16 along the reference's last axis fall whole on every
    rank's shard of the reduced model (its 64- and 128-wide axes cut in 2);
    blocks of 48 straddle the ranks.  A code may sit a rounding apart where
    the two steps' gradients do (the share of such codes is printed)."""
    for coords, res in _runs(parity, (2, 2), f"dense/{tag}"):
        assert max(res["loss"], res["params"], res["mu"]) <= TOL, (coords,
                                                                   res)
        assert res["codes_within_one"] and res["codes_off"] < 1e-3, res
        assert res["scale_rel"] <= 1e-4, (coords, res)


def test_gqa_kv_head_shared_by_two_tp_ranks(parity):
    """Reduced qwen2-72b with 2 KV heads at tp 4: ranks 0-1 read KV head 0,
    ranks 2-3 head 1, and their ``wk``/``wv`` gradients are summed over
    exactly those pairs."""
    cfg = ranks.case_config("gqa")
    assert [kv_heads(cfg.num_heads, 2, 4, r, True) for r in range(4)] == \
        [(0, 1), (0, 1), (1, 1), (1, 1)]
    for coords, res in _runs(parity, (1, 4), "gqa/1x4"):
        assert max(res[k] for k in ("loss", "params", "mu", "nu")) <= TOL


@pytest.mark.parametrize("block", [16, 48], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("path", ["blocks/0/attn/wq", "blocks/0/attn/wo",
                                  "blocks/0/mlp/wd", "embed"])
def test_sharded_quantizer_equals_the_reference_bit_for_bit(
        tmp_path_factory, path, block):
    """The same non-negative tensor through the reference's
    ``_quantize_blocks`` whole and through the port's sharded quantizer on
    each rank's part of it on (2, 2): every code and block scale equal
    (the block maxima are MAX-all-reduced over the ranks that split the
    axis)."""
    import jax.numpy as jnp
    from repro.train.optimizer import _quantize_blocks
    from repro_torch.distributed.sharding import take
    from repro_torch.models.common import full_shapes
    cfg = ranks.case_config("dense")
    shape = full_shapes(cfg)[path]
    x = np.random.default_rng(2).random(shape, dtype=np.float32) ** 4
    transposed = path != "embed"
    ref_x = x.T if transposed else x
    q, s = (np.asarray(a) for a in _quantize_blocks(jnp.asarray(ref_x),
                                                    block))
    if transposed:
        q, s = q.T, s.T
    got = _spawn(tmp_path_factory, ranks.quantize_split, 4, 2, 2, x, path,
                 "dense", block)
    assert any(r["split"] for r in got)
    for r in got:
        index = list(r["index"])
        assert np.array_equal(r["q"].numpy(), take(q, tuple(index)))
        index[r["axis"]] = None
        assert np.array_equal(r["scale"].numpy(), take(s, tuple(index)))


@pytest.mark.parametrize("case,knob", [
    ("dense", "dots"), ("dense", "seq_shard"), ("moe", "seq_shard"),
    ("hybrid", "seq_shard"), ("hybrid", "dots"), ("audio", "attn_q_chunk"),
    ("audio", "dots")])
def test_env_knobs_leave_the_gradients_as_the_default(knobs, case, knob):
    """``remat_policy="dots"`` (keep matrix products, recompute the rest),
    ``seq_shard_activations`` (the residual stream split over tp along the
    sequence) and ``attn_q_chunk`` (the plain attention by query chunks:
    whisper's encoder) give the default's loss and gradients on (2, 2)."""
    for res in knobs:
        assert res[f"{case}/{knob}"] <= 1e-5, res


def test_elastic_restore_onto_another_mesh(tmp_path_factory, tmp_path):
    """A train state saved sharded on (2, 2) writes the files a one-device
    save writes, bit for bit, and restores onto (1, 2) and onto one device
    bit for bit (the reference's ``test_fault_tolerance.py`` elastic
    re-mesh and ``test_train.py``'s ``sharding_fn`` restore)."""
    from repro_torch.train import (AdamWConfig, Checkpointer,
                                   init_train_state, make_train_step)
    from repro_torch.train.tree import tree_leaves_with_path
    cfg = ranks.case_config("dense")
    api = ranks.get_model(cfg)
    opt = AdamWConfig(**ranks.TRAIN_OPT)
    env = ranks.env_for_mesh(None, "cpu", compute_dtype=torch.float32)
    state = init_train_state(api, torch.Generator().manual_seed(0), opt,
                             device="cpu")
    state, _ = make_train_step(api, env, opt)(state, ranks._knob_batch(cfg))
    state_file = str(tmp_path / "state.pt")
    torch.save(state, state_file)
    one_dir, mesh_dir = tmp_path / "one", tmp_path / "mesh"
    Checkpointer(str(one_dir), async_save=False).save(3, state)
    assert all(_spawn(tmp_path_factory, ranks.elastic_save, 4, 2, 2,
                      str(mesh_dir), state_file))
    files = sorted(os.listdir(one_dir / "step_00000003"))
    assert files == sorted(os.listdir(mesh_dir / "step_00000003"))
    for name in files:
        a, b = (d / "step_00000003" / name for d in (one_dir, mesh_dir))
        assert a.read_bytes() == b.read_bytes(), name
    for res in _spawn(tmp_path_factory, ranks.elastic_restore, 2, 1, 2,
                      str(mesh_dir), state_file):
        assert res["equal"] and res["step"] == 3 and res["leaves"] > 30
    got, step, _ = Checkpointer(str(mesh_dir)).restore(state)
    assert step == 3
    for (k, a), (_, b) in zip(tree_leaves_with_path(got),
                              tree_leaves_with_path(state)):
        assert torch.equal(a, b), k


def test_launcher_trains_on_a_mesh_and_restarts_on_another(tmp_path):
    """``python -m repro_torch.launch.train --mesh 2,2 --device cpu`` trains
    on four gloo ranks and checkpoints; relaunched with ``--mesh 1,2`` on
    the same directory it restores that checkpoint onto the new mesh and
    continues from its step (the reference launcher's restart, across
    meshes)."""
    from repro_torch.launch.train import main
    argv = ["--device", "cpu", "--scale", "10m", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path)]
    first = main(argv + ["--mesh", "2,2", "--steps", "2"])
    assert first["steps"] == 2 and first["start_step"] == 0
    assert len(first["peak_mem_bytes_by_rank"]) == 4
    assert all(np.isfinite(first["losses"]))
    assert first["collectives"]["step"]["counts"]["all-gather"] > 0
    again = main(argv + ["--mesh", "1,2", "--steps", "3"])
    assert again["start_step"] == 2 and again["steps"] == 1
    assert np.isfinite(again["losses"][0])
