"""The port's planner core, roofline and serving planner against the
reference's.

``plan`` on the paper DAGs with ``paper_library()`` must give the same
allocation, slot counts and thread-to-slot mapping.  The roofline is
evaluated under a ``Hardware`` holding the reference's own constants, where
it must agree within 1e-12; ``plan_serving`` under that hardware must pick
the reference's GPU (chip) counts and hosts.
"""

import dataclasses

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.core import ALL_DAGS as JAX_DAGS
from repro.core import paper_library as jax_paper_library
from repro.core import plan as jax_plan
from repro.distributed import roofline as jax_roofline
from repro.serve import plan_serving as jax_plan_serving
from repro_torch.configs.base import ModelConfig
from repro_torch.core import paper_library, plan
from repro_torch.core.dag import ALL_DAGS
from repro_torch.distributed.roofline import (H100_SXM, Hardware,
                                              flops_per_token,
                                              stage_hbm_fraction,
                                              stage_tokens_per_sec)
from repro_torch.serve import plan_serving

REF_HW = Hardware(name="reference constants",
                  peak_flops=jax_roofline.PEAK_FLOPS,
                  hbm_bw=jax_roofline.HBM_BW, link_bw=jax_roofline.ICI_BW,
                  hbm_bytes=jax_roofline.CHIP_HBM,
                  matrix_tile=jax_roofline.MXU_TILE)


def _summary(s):
    return {
        "threads": {t: a.threads for t, a in s.allocation.tasks.items()},
        "estimated": s.estimated_slots,
        "acquired": s.acquired_slots,
        "vms": [(vm.id, vm.num_slots) for vm in s.vms],
        "mapping": sorted((repr(th), sl.vm, sl.slot)
                          for th, sl in s.mapping.assignment.items()),
    }


@pytest.mark.parametrize("dag", sorted(ALL_DAGS))
@pytest.mark.parametrize("allocator,mapper", [("mba", "sam"), ("lsa", "dsm"),
                                              ("mba", "rsm")])
def test_plan_matches_reference(dag, allocator, mapper):
    assert sorted(ALL_DAGS) == sorted(JAX_DAGS)
    lib, jlib = paper_library(), jax_paper_library()
    for omega in (50.0, 100.0, 200.0):
        ours = plan(ALL_DAGS[dag](), omega, lib, allocator=allocator,
                    mapper=mapper)
        ref = jax_plan(JAX_DAGS[dag](), omega, jlib, allocator=allocator,
                       mapper=mapper)
        assert _summary(ours) == _summary(ref), (dag, omega)


def _port_cfg(name):
    return ModelConfig(**dataclasses.asdict(JAX_ARCHS[name]))


ARCH_SAMPLE = ["minicpm-2b", "moonshot-v1-16b-a3b", "mamba2-370m",
               "zamba2-1.2b", "whisper-large-v3", "qwen2-72b"]


@pytest.mark.parametrize("arch", ARCH_SAMPLE)
def test_roofline_matches_reference_constants(arch):
    cfg, jcfg = _port_cfg(arch), JAX_ARCHS[arch]
    for chips in (1, 2, 4, 8, 16):
        for stage in ("prefill", "decode"):
            for batch, context in ((1, 512), (32, 4096)):
                ours = stage_tokens_per_sec(cfg, chips=chips, batch=batch,
                                            context=context, stage=stage,
                                            hardware=REF_HW)
                ref = jax_roofline.stage_tokens_per_sec(
                    jcfg, chips=chips, batch=batch, context=context,
                    stage=stage)
                assert ours == pytest.approx(ref, rel=1e-12, abs=0)
        frac = stage_hbm_fraction(cfg, chips=chips, batch=8, context=2048,
                                  hardware=REF_HW)
        assert frac == pytest.approx(jax_roofline.stage_hbm_fraction(
            jcfg, chips=chips, batch=8, context=2048), rel=1e-12, abs=0)
    assert flops_per_token(cfg, 1024) == jax_roofline.flops_per_token(jcfg, 1024)


@pytest.mark.parametrize("rate", [1.0, 4.0, 16.0, 64.0])
def test_plan_serving_matches_reference_under_its_constants(rate):
    cfg, jcfg = _port_cfg("minicpm-2b"), JAX_ARCHS["minicpm-2b"]
    kw = dict(request_rate=rate, prompt_len=2048, gen_len=128)
    ours = plan_serving(cfg, hardware=REF_HW, **kw)
    ref = jax_plan_serving(jcfg, **kw)
    assert (ours.prefill_chips, ours.decode_chips, ours.hosts) == \
        (ref.prefill_chips, ref.decode_chips, ref.hosts)
    assert ours.schedule.acquired_slots == ref.schedule.acquired_slots


def test_plan_serving_on_h100_datasheet():
    sp = plan_serving(_port_cfg("minicpm-2b"), request_rate=4.0,
                      prompt_len=1024, gen_len=32)
    assert sp.hardware is H100_SXM
    assert sp.prefill_chips >= 1 and sp.decode_chips >= 1 and sp.hosts >= 1
    assert "H100" in sp.describe()
    assert {vm.vm_class for vm in sp.schedule.vms} <= {
        "gpu-host4", "gpu-host2", "gpu-host1"}
