"""Every collective of the port goes through ``distributed/collectives.py``,
which records it as the reference's HLO parser counts the collectives of a
compiled program: the three ops of the parser's own test
(``tests/test_system.py::test_hlo_collective_parser``) issued through the
wrappers over gloo give the same counts, raw bytes and ring-factor wire
bytes, and a tp 2 decode step records exactly the collectives the design
predicts.
"""

import pytest
import torch

import _torch_ranks as ranks
from repro.distributed.hloparse import parse_collectives
from repro_torch.distributed.collectives import CollectiveStats, recording
from repro_torch.distributed.spawn import spawn

HLO = """
  %ag = bf16[16,1024]{1,0} all-gather(%x), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[256]{0} all-reduce(%y), replica_groups=[8,2]<=[16], to_apply=%add
  %a2a.1 = (f32[4,8]{1,0}, f32[4,8]{1,0}) all-to-all(%a, %b), replica_groups={{0,1}}
"""


def test_three_ops_record_what_the_reference_parses(tmp_path):
    want = parse_collectives(HLO)
    out = spawn(ranks.three_collectives, 4, device="cpu", threads=1,
                timeout=120, workdir=str(tmp_path))
    for r in out:
        stats = r["stats"]
        assert stats["counts"] == want.counts
        assert stats["raw_bytes"] == want.raw_bytes
        assert stats["wire_bytes"] == pytest.approx(want.wire_bytes)
        assert r["gather"].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert r["reduce"] == 2.0
    # the all-to-all sends block j to the pair's rank j, and block j of
    # what a rank gets came from the pair's rank j (pairs {0, 2}, {1, 3})
    assert out[0]["a2a"].tolist() == [0.0, 2.0]
    assert out[2]["a2a"].tolist() == [10.0, 12.0]
    assert out[3]["a2a"].tolist() == [11.0, 13.0]


def test_stats_fields_and_ring_factors():
    stats = CollectiveStats()
    stats.add("all-gather", 32768, 4)
    stats.add("all-reduce", 1024, 1)
    stats.add("collective-permute", 64, 4)
    stats.add("collective-permute", 64, 1, moved=False)
    assert stats.counts == {"all-gather": 1, "all-reduce": 1,
                            "collective-permute": 2}
    assert stats.wire_bytes["all-gather"] == 32768 * 3 / 4
    # a group of one moves nothing
    assert stats.wire_bytes["all-reduce"] == 0.0
    assert stats.wire_bytes["collective-permute"] == 64.0
    assert stats.total_raw_bytes == 32768 + 1024 + 128
    assert "all-gather: n=1" in stats.summary()
    with recording() as active:
        pass
    assert active.counts == {}


def test_tp2_decode_step_records_the_predicted_collectives(tmp_path):
    """Dense reduced (2 layers, D 64, tied vocab 256) at tp 2, two
    sequences in fp32: the vocab-parallel embedding's all-reduce, one
    after each layer's attention and one after its MLP, and the head's
    all-gather of the (2, 1, 128)-logit halves."""
    out = spawn(ranks.decode_collectives, 2, args=(2,), device="cpu",
                threads=1, timeout=120, workdir=str(tmp_path))
    act = 2 * 1 * 64 * 4                    # (B, 1, D) fp32
    logits = 2 * 2 * 1 * 128 * 4            # 2 ranks' (B, 1, V/2) fp32
    for stats in out:
        assert stats["counts"] == {"all-reduce": 1 + 2 * 2, "all-gather": 1}
        assert stats["raw_bytes"] == {"all-reduce": 5 * act,
                                      "all-gather": logits}
        assert stats["wire_bytes"] == pytest.approx(
            {"all-reduce": 5 * act * 2 * 1 / 2, "all-gather": logits / 2})
