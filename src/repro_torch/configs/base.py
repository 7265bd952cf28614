"""Architecture + run-shape configuration system.

``ModelConfig`` covers the six model families of the assigned pool
(dense / moe / ssm / hybrid / encdec / vlm); ``HybridMoEConfig`` the port's
``hybrid_moe`` (Mamba2, sparse-MoE and attention layers in a per-layer
pattern, as Nemotron-H).  ``ShapeConfig`` is the assigned input-shape set.
``reduced()`` derives the CPU-smoke-test variant of any config (same
family/topology, tiny dimensions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
                                   # | hybrid_moe
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free (pure SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    shared_experts: int = 0
    moe_capacity: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style shared attention blocks)
    attn_period: int = 0           # shared attn block every N ssm layers

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # stubbed frame-embedding length

    # vlm (phi-3-vision): stubbed patch embeddings prepended
    num_patches: int = 0

    # training defaults
    lr_schedule: str = "cosine"    # "wsd" for minicpm

    # Every family but hybrid_moe has these values; they are class
    # attributes and not fields, so that the ten reference configs keep the
    # reference's fields (``HybridMoEConfig`` makes them fields).
    layer_pattern = ""             # one letter a layer: M Mamba2, E MoE, * attn
    use_rope = True
    ssm_heads = 0                  # Mamba2 heads; 0: expand * d_model / head_dim
    ssm_groups = 1                 # groups of B/C, each shared by H / G heads
    ssm_gate_first = False         # y * silu(z), then RMS norm per group
    shared_d_ff = 0                # shared expert width; 0: shared_experts * d_ff
    routed_scale = 1.0             # the routed experts' weights times this

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def ssm_inner(self) -> int:
        """The Mamba2 width: heads times head width where the heads are
        given, else ``ssm_expand * d_model``."""
        if self.ssm_heads:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def layer_kinds(self) -> str:
        """One letter a layer: the pattern of ``hybrid_moe``; every other
        family's layers are all of one kind (M for ssm and hybrid, * for
        the attention families)."""
        if self.family == "hybrid_moe":
            return self.layer_pattern
        return ("M" if self.family in ("ssm", "hybrid") else "*") \
            * self.num_layers

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def full_attention(self) -> bool:
        """True if every token attends over the full context through an
        O(L^2) dense-attention path (disqualifies long_500k)."""
        if self.family == "ssm":
            return False
        if self.family in ("hybrid", "hybrid_moe"):
            return False  # few attention layers; O(L) state dominates
        return True

    # -- derived sizes ---------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = V * D                       # embed
        if not self.tie_embeddings:
            total += D * V                  # head
        def attn_params() -> int:
            p = D * H * hd + 2 * D * K * hd + H * hd * D
            if self.qkv_bias:
                p += H * hd + 2 * K * hd
            return p
        def dense_ffn() -> int:
            return 3 * D * F                # swiglu gate/up/down
        def moe_ffn() -> int:
            experts = self.num_experts * self.expert_mats * D * F
            router = D * self.num_experts
            shared = self.expert_mats * D * self.shared_width
            return experts + router + shared
        def ssm_params() -> int:
            d_in = self.ssm_inner
            nheads = d_in // self.ssm_head_dim
            bc = 2 * self.ssm_groups * self.ssm_state
            # in_proj -> (z, x, B, C, dt) ; out_proj ; conv ; A, D, dt_bias
            in_p = D * (2 * d_in + bc + nheads)
            out_p = d_in * D
            conv = self.ssm_conv_width * (d_in + bc)
            return in_p + out_p + conv + 3 * nheads
        if self.family in ("dense", "vlm"):
            total += L * (attn_params() + dense_ffn() + 2 * D)
        elif self.family == "moe":
            total += L * (attn_params() + moe_ffn() + 2 * D)
        elif self.family == "ssm":
            total += L * (ssm_params() + 2 * D)
        elif self.family == "hybrid":
            # mamba2 backbone; d_ff lives only in the ONE weight-shared
            # attention+MLP block applied every attn_period layers
            total += L * (ssm_params() + D)
            total += attn_params() + dense_ffn() + 2 * D
        elif self.family == "hybrid_moe":
            # one pre-norm mixer a layer; Mamba2's conv bias and gated-norm
            # gain, the router's correction bias
            d_conv = self.ssm_inner + 2 * self.ssm_groups * self.ssm_state
            per = {"M": ssm_params() + d_conv + self.ssm_inner,
                   "E": moe_ffn() + self.num_experts,
                   "*": attn_params()}
            total += sum(per[k] + D for k in self.layer_pattern) + D
        elif self.family == "audio":
            gelu_ffn = 2 * D * F           # whisper: fc1/fc2 GELU MLP
            enc = self.encoder_layers * (attn_params() + gelu_ffn + 2 * D)
            dec = L * (2 * attn_params() + gelu_ffn + 3 * D)
            total += enc + dec
        return total

    @property
    def expert_mats(self) -> int:
        """Weight matrices an expert holds: gate, up and down (SwiGLU);
        hybrid_moe's relu^2 experts up and down."""
        return 2 if self.family == "hybrid_moe" else 3

    @property
    def shared_width(self) -> int:
        """The shared experts' hidden width, all of them together."""
        return self.shared_d_ff or self.shared_experts * self.d_ff

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        if self.family == "hybrid_moe":
            per = self.expert_mats * self.d_model * self.d_ff
            unused = (self.num_experts - self.experts_per_token) * per
            return self.param_count() - self.layer_pattern.count("E") * unused
        D, F, L = self.d_model, self.d_ff, self.num_layers
        dense_total = self.param_count()
        all_experts = L * self.num_experts * 3 * D * F
        active_experts = L * (self.experts_per_token + self.shared_experts) * 3 * D * F
        return dense_total - all_experts + L * self.experts_per_token * 3 * D * F \
            + 0 * active_experts

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small_heads = max(2, min(4, self.num_heads)) if self.num_heads else 0
        kv = min(self.num_kv_heads, small_heads) if self.num_kv_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(2, self.num_layers) if self.family != "hybrid" else 4,
            d_model=64,
            num_heads=small_heads,
            num_kv_heads=max(1, kv),
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_experts=min(4, self.num_experts),
            experts_per_token=min(2, self.experts_per_token),
            shared_experts=min(1, self.shared_experts),
            ssm_state=min(16, self.ssm_state),
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_period=2 if self.attn_period else 0,
            encoder_layers=min(2, self.encoder_layers),
            encoder_seq=min(16, self.encoder_seq),
            num_patches=min(4, self.num_patches),
        )


#: ``hybrid_moe``'s reduced layers: every kind, a Mamba2 layer after the
#: attention one (its cache beside the K/V)
REDUCED_PATTERN = "ME*ME"


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """The ``hybrid_moe`` family (Nemotron-H): a pattern of Mamba2 (M),
    sparse-MoE (E) and attention (*) layers, each ``x + mixer(norm(x))``.
    The fields below are the base's class attributes made fields."""
    layer_pattern: str = ""
    use_rope: bool = True
    ssm_heads: int = 0
    ssm_groups: int = 1
    ssm_gate_first: bool = False
    shared_d_ff: int = 0
    routed_scale: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_pattern) != self.num_layers or \
                set(self.layer_pattern) - set("ME*"):
            raise ValueError(f"{self.name}: layer_pattern must hold "
                             f"{self.num_layers} letters of M, E, *; got "
                             f"{self.layer_pattern!r}")

    def reduced(self) -> "HybridMoEConfig":
        """Every kind of layer, two groups of B/C, GQA, top-2 of 8."""
        return dataclasses.replace(
            self, name=self.name + "-smoke", layer_pattern=REDUCED_PATTERN,
            num_layers=len(REDUCED_PATTERN), d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
            num_experts=8, experts_per_token=2, shared_d_ff=64,
            ssm_state=16, ssm_head_dim=16, ssm_heads=8, ssm_groups=2,
            ssm_chunk=16)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason-if-not) — the DESIGN.md §Arch-applicability rules."""
    if shape.name == "long_500k" and cfg.full_attention:
        return False, ("pure full-attention arch: 524k dense KV at batch 1 is "
                       "the quadratic regime this shape excludes (DESIGN.md §5)")
    return True, ""
