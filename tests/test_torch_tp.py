"""The port served sharded over ranks, against the reference's sharded
program.

The reference runs in one subprocess (``tests/_torch_shard_ref.py``, 4
forced host devices, its ``prefill`` and ``decode_step`` jitted under
``env_for_mesh`` on (1, 2), (1, 4) and (2, 2) meshes) and writes ``.npz``
files; the port runs the same weights and inputs on the same meshes as
gloo rank processes on the CPU (``repro_torch.distributed.spawn``, one
thread a rank, the rank bodies in ``tests/_torch_ranks.py``).  Each rank
holds its part of the reference's outputs: prefill and decode logits and
every cache entry within 1e-4 (the families' parity tolerance), the MoE
routing decisions and drops equal (capacity from each rank's own tokens,
as the reference's ``shard_map`` body computes it), and the rank's init
shard equal to its part of the one-device init.  Then greedy tokens at
tp 2 equal the one-device port's.
"""

import os
import subprocess
import sys

import pytest
import torch

import _torch_ranks as ranks
from repro_torch.distributed.spawn import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
MESHES = ((1, 2), (1, 4), (2, 2))
CASES = sorted(ranks.CASES)
RANK_TIMEOUT = 240


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard_ref")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_shard_ref.py"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    state = {"dir": str(out), "proc": proc, "done": False}
    yield state
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _ready(reference):
    if not reference["done"]:
        stdout, stderr = reference["proc"].communicate(timeout=600)
        assert reference["proc"].returncode == 0 and \
            "SHARD_REF_OK" in stdout, stdout[-2000:] + stderr[-3000:]
        reference["done"] = True
    return reference["dir"]


@pytest.fixture(scope="module")
def served(tmp_path_factory, reference):
    """Started while the reference computes: tokens at tp 2 against one
    device."""
    return spawn(ranks.serve_tokens, 2, args=(2,), device="cpu",
                 threads=1, timeout=RANK_TIMEOUT,
                 workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def parity(tmp_path_factory, reference, served):
    ref_dir = _ready(reference)
    out = {}
    for data, model in MESHES:
        out[(data, model)] = spawn(
            ranks.parity, data * model, args=(ref_dir, data, model, CASES),
            device="cpu", threads=1, timeout=RANK_TIMEOUT,
            workdir=str(tmp_path_factory.mktemp("ranks")))
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_prefill_and_decode_match_the_reference(parity, mesh, case):
    results = parity[mesh]
    assert sorted((r["coords"]["data"], r["coords"]["model"])
                  for r in results) == [(d, m) for d in range(mesh[0])
                                        for m in range(mesh[1])]
    for r in results:
        res = r[case]
        errs = {k: v for k, v in res.items() if isinstance(v, float)}
        assert any(k.startswith("decode1") for k in errs)
        assert any("cache" in k for k in errs)
        assert max(errs.values()) <= TOL, (r["coords"], errs)
        assert res["routes_equal"], r["coords"]
        assert res["init_equal"], r["coords"]


def test_greedy_tokens_at_tp2_equal_one_device(served):
    for tokens in served:
        assert tokens["sharded"] == tokens["one"]
        assert [len(tokens["one"][i]) for i in range(5)] == [3, 7, 2, 6, 4]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_launcher_refuses_without_a_card_unless_asked_for_the_cpu():
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--tp", "2", "--requests", "1"])
