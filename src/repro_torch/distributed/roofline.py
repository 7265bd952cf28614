"""Roofline terms and analytic estimators, on a stated card.

Two uses, as the reference's ``repro/distributed/roofline.py``:

1. the dry run's roofline (``launch/dryrun.py``): a cell's per-device
   FLOPs, bytes and collective wire bytes turned into three times
   (:func:`terms_from_compiled`);
2. the serving planner's PerfModels: tokens/s of a model stage as a
   function of the GPUs assigned — the LM-stage analogue of the paper's
   thread->rate profiles (non-linear for the same root cause: contention
   on the interconnect and sub-efficient matrix tiles).

The formulas are the reference's; the hardware they are evaluated on is an
explicit :class:`Hardware` argument (:data:`H100_SXM` by default) instead
of the reference's module constants, which describe a TPU.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator's peak rates and sizes, as the roofline reads them."""

    name: str
    peak_flops: float        # dense bf16 FLOP/s per device
    hbm_bw: float            # device-memory bytes/s per device
    link_bw: float           # interconnect bytes/s per device, each way
    hbm_bytes: float         # device-memory bytes per device
    #: matrix-unit tile width: per-device shares of d_model below it lose a
    #: factor (the "flat-then-drop" of small per-device work)
    matrix_tile: int

    def describe(self) -> str:
        return (f"Hardware[{self.name}]: {self.peak_flops:.4g} FLOP/s bf16, "
                f"HBM {self.hbm_bw:.4g} B/s x {self.hbm_bytes:.4g} B, "
                f"link {self.link_bw:.4g} B/s, tile {self.matrix_tile}")


#: NVIDIA H100 SXM, datasheet values (dense, no sparsity, at the 700 W
#: limit): 989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, 80e9 B HBM, NVLink 900 GB/s
#: per card = 450e9 B/s each way.  The tile width is wgmma's 64-row M
#: dimension: a warpgroup's matrix product issues 64 rows at a time, so a
#: per-device share of d_model below 64 leaves part of each product idle.
H100_SXM = Hardware(name="H100-SXM (datasheet)", peak_flops=989e12,
                    hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9,
                    matrix_tile=64)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """The bound: the largest term (perfect overlap of the three)."""
        return max(self.compute_s, self.memory_s, self.collective_s)


def terms_from_compiled(flops_per_device: float, bytes_per_device: float,
                        collective_bytes_per_device: float, *,
                        hardware: Hardware = H100_SXM,
                        links: int = 1) -> RooflineTerms:
    """The three roofline times of one device's step on ``hardware``:
    FLOPs over its bf16 peak, bytes over its memory rate, collective wire
    bytes over ``links`` of its interconnect."""
    return RooflineTerms(
        compute_s=flops_per_device / hardware.peak_flops,
        memory_s=bytes_per_device / hardware.hbm_bw,
        collective_s=collective_bytes_per_device / (hardware.link_bw
                                                    * links))


def flops_per_token(cfg: ModelConfig, seq_in_context: int) -> float:
    """Forward FLOPs per token: 2*N_active + attention O(S) term."""
    n = cfg.active_param_count()
    fl = 2.0 * n
    if cfg.num_heads:
        # score+value matmuls over the live context; hybrids only attend in
        # their shared blocks (every attn_period layers)
        L = cfg.num_layers
        if cfg.family == "hybrid" and cfg.attn_period:
            L = cfg.num_layers // cfg.attn_period
        if cfg.family == "hybrid_moe":
            L = cfg.layer_pattern.count("*")
        if cfg.family == "audio":
            L = cfg.num_layers  # decoder self-attn; cross-attn term below
            fl += 4.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim \
                * cfg.encoder_seq
        fl += 4.0 * L * cfg.num_heads * cfg.head_dim * seq_in_context
    return fl


def _param_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> float:
    return cfg.param_count() * dtype_bytes


def _kv_bytes_per_token(cfg: ModelConfig, context: int,
                        dtype_bytes: int = 2) -> float:
    if cfg.family == "hybrid_moe":
        # K/V of the attention layers; the Mamba2 layers' fp32 state
        state = (cfg.layer_pattern.count("M") * cfg.ssm_inner
                 * cfg.ssm_state * 4.0)
        return (cfg.layer_pattern.count("*") * 2 * cfg.num_kv_heads
                * cfg.head_dim * context * dtype_bytes + state)
    if not cfg.num_heads:
        # SSM state is O(1); conv + state per decode step
        d_in = cfg.ssm_expand * cfg.d_model
        nheads = max(1, d_in // cfg.ssm_head_dim)
        return cfg.num_layers * nheads * cfg.ssm_head_dim * cfg.ssm_state * 4.0
    return (cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
            * context * dtype_bytes)


def stage_tokens_per_sec(cfg: ModelConfig, *, chips: int, batch: int,
                         context: int, stage: str,
                         hardware: Hardware = H100_SXM,
                         efficiency: float = 0.55) -> float:
    """Analytic sustained tokens/s for ``stage`` ("prefill" | "decode")
    on ``chips`` devices — a roofline max of compute / HBM / link terms.

    Non-linearity in ``chips``: collective time per token grows with the
    TP width (all-reduce bytes ~ 2*D per token per layer boundary regardless
    of devices, but link bandwidth per device is fixed while compute
    shrinks), and small per-device matmul tiles fall off the tile cliff.
    """
    assert stage in ("prefill", "decode")
    hw = hardware
    tokens_in_flight = batch * (context if stage == "prefill" else 1)
    fl = flops_per_token(cfg, context) * tokens_in_flight
    compute_s = fl / (chips * hw.peak_flops * efficiency)
    # tile penalty: per-device share of d_model below the tile wastes lanes
    per_chip_d = cfg.d_model / max(1, chips // 8)
    if per_chip_d < hw.matrix_tile:
        compute_s *= hw.matrix_tile / max(per_chip_d, 8)
    # memory: decode re-reads all params + KV every step
    if stage == "decode":
        bytes_step = _param_bytes(cfg) + batch * _kv_bytes_per_token(cfg, context)
        memory_s = bytes_step / (chips * hw.hbm_bw)
    else:
        bytes_step = _param_bytes(cfg) + 0.15 * fl / hw.peak_flops * hw.hbm_bw
        memory_s = bytes_step / (chips * hw.hbm_bw)
    # collectives: 2 all-reduces of (tokens, D) per layer across the TP group
    tp = min(chips, 16)
    coll_bytes = (2 * cfg.num_layers * tokens_in_flight * cfg.d_model * 2
                  * 2 * (tp - 1) / tp)
    collective_s = coll_bytes / (chips * hw.link_bw)
    step_s = max(compute_s, memory_s, collective_s)
    return tokens_in_flight / step_s


def stage_hbm_fraction(cfg: ModelConfig, *, chips: int, batch: int,
                       context: int, hardware: Hardware = H100_SXM) -> float:
    """Fraction of the pool's device memory used by params + KV (the
    'memory%' of the paper's models)."""
    need = _param_bytes(cfg) + batch * _kv_bytes_per_token(cfg, context)
    return need / (chips * hardware.hbm_bytes)
