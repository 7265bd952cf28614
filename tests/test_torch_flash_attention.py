"""The port's flash attention against the reference's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the reference
runs its Pallas kernel in interpret mode.  Inputs are made with numpy from
a seed and handed to both.  Tolerances are the reference's own
(tests/test_kernels.py): fp32 2e-6, bf16 2e-2, q_offset 1e-5.  Both modes
run: causal, and ``causal=False`` (every key visible, ``q_offset`` ignored),
which the reference's kernel takes but its own tests never call.  The CUDA
kernel itself is held against the plain version on the card (``cuda``
marker; ``python3 chip_smoke.py`` does the same at the serving shape).
The bf16 CUDA kernel runs on the tensor cores; its rounding points are
rehearsed here on the CPU (``_tensor_core_emulation``) against the
reference at the bf16 tolerance.
The GPU machine has no JAX, so the reference is imported inside the tests
that use it and the ``cuda`` tests run there with ``--noconftest -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.ref import reference_attention

SHAPES = [
    (2, 64, 64, 4, 2, 32),     # GQA
    (1, 128, 128, 8, 8, 64),   # MHA
    (2, 96, 96, 4, 1, 16),     # MQA, non-pow2 seq
    (1, 64, 64, 2, 2, 112),    # kimi-style head_dim (padded to 128)
    (1, 24, 150, 4, 2, 64),    # cross-attention: Sq != Skv, ragged Skv
]
DTYPES = {"float32": ("float32", torch.float32, 2e-6),
          "bfloat16": ("bfloat16", torch.bfloat16, 2e-2)}


def _jax():
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention
    return jnp, flash_attention


def _mk_qkv(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, K, hd)).astype(np.float32))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _modes(shapes, name):
    """Each shape causal (its id as before) and non-causal."""
    return [pytest.param(s, causal, id=name(i, s) + ("" if causal
                                                    else "-noncausal"))
            for causal in (True, False) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("shape,causal",
                         _modes(SHAPES, lambda i, s: f"shape{i}"))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_matches_reference(shape, dtype, causal):
    jnp, jax_flash = _jax()
    B, Sq, Skv, H, K, hd = shape
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _mk_qkv(42, B, Sq, Skv, H, K, hd)
    ref = jax_flash(*(jnp.asarray(a, getattr(jnp, jdt)) for a in arrays),
                    causal=causal, interpret=True)
    out = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in arrays),
                              causal=causal)
    assert out.shape == (B, Sq, H, hd) and out.dtype == tdt
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


def test_flash_attention_q_offset():
    """Chunked-prefill masking: the query block starts at position 32."""
    jnp, jax_flash = _jax()
    B, S, H, K, hd = 1, 32, 2, 2, 16
    arrays = _mk_qkv(7, B, S, 2 * S, H, K, hd)
    off = np.full((B,), 32, np.int32)
    ref = jax_flash(*(jnp.asarray(a) for a in arrays),
                    q_offset=jnp.asarray(off), interpret=True)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in arrays),
                              q_offset=torch.from_numpy(off))
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_noncausal_ignores_q_offset(dtype):
    """With causal=False the offset plays no part, in the port as in the
    reference: an offset of 7 changes neither output by a bit."""
    jnp, jax_flash = _jax()
    jdt, tdt, tol = DTYPES[dtype]
    B, Sq, Skv, H, K, hd = 2, 24, 150, 4, 2, 64
    arrays = _mk_qkv(5, B, Sq, Skv, H, K, hd)
    off = np.full((B,), 7, np.int32)
    jx = [jnp.asarray(a, getattr(jnp, jdt)) for a in arrays]
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    refs = [jax_flash(*jx, q_offset=o, causal=False, interpret=True)
            for o in (None, jnp.asarray(off))]
    outs = [ops.flash_attention(*tx, q_offset=o, causal=False)
            for o in (None, torch.from_numpy(off))]
    np.testing.assert_array_equal(_f32(refs[1]), _f32(refs[0]))
    assert torch.equal(outs[1], outs[0])
    np.testing.assert_allclose(_f32(outs[1]), _f32(refs[1]), rtol=tol,
                               atol=tol)


def _tensor_core_emulation(q, k, v, q_offset, sm_scale, block_k=64,
                           causal=True):
    """The bf16 tensor-core kernel's arithmetic in plain PyTorch: q, k, v
    in bf16 (B, heads, S, hd); S = q k^T with fp32 sums; the online softmax
    over 64-key tiles in the log2 domain (exp2, sm_scale * log2 e folded
    into one multiply); P rounded to bf16 before P V, the row sums taken
    over the unrounded P in fp32; the output rounded to bf16.  Non-causal,
    every key of every tile is visible."""
    B, H, Sq, hd = q.shape
    G = H // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    scale = sm_scale * math.log2(math.e)
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, hd)
    q_pos = torch.arange(Sq)[None] + q_offset[:, None].long()
    for k0 in range(0, kf.shape[2], block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        k_pos = torch.arange(k0, k0 + kt.shape[2])
        if causal:
            visible = k_pos[None, None] <= q_pos[:, :, None]      # (B, Sq, T)
            s = torch.where(visible[:, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


TC_SHAPES = [                       # (B, Sq, Skv, H, K, hd, q_offset)
    (1, 1024, 1024, 4, 4, 64, 0),   # minicpm / zamba2 prefill, 4 heads
    (2, 200, 200, 8, 2, 128, 0),    # GQA, ragged last tile, hd 128
    (1, 33, 33, 4, 4, 64, 0),       # below one tile
    (2, 96, 256, 4, 4, 64, 160),    # q_offset
]
NONCAUSAL_TC_SHAPES = [
    (1, 1500, 1500, 2, 2, 64, 0),   # whisper's encoder length, 2 heads
    (1, 24, 150, 4, 2, 64, 0),      # cross-attention, ragged Skv
    (2, 200, 200, 8, 2, 128, 0),    # GQA, ragged last tile, hd 128
    (1, 33, 33, 4, 4, 64, 0),       # below one tile
    (2, 96, 256, 4, 4, 64, 160),    # q_offset, which plays no part
]


def _tc_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize(
    "shape,causal",
    [pytest.param(s, True, id=_tc_id(s)) for s in TC_SHAPES]
    + [pytest.param(s, False, id=_tc_id(s) + "-noncausal")
       for s in NONCAUSAL_TC_SHAPES])
def test_tensor_core_numerics_match_reference(shape, causal):
    """The bf16 kernel's rounding points (exp2, P in bf16 before P V) stay
    within the bf16 tolerance of the reference on the same bf16 inputs."""
    jnp, _ = _jax()
    from repro.kernels.flash_attention.ref import reference_attention as jax_ref
    B, Sq, Skv, H, K, hd, off = shape
    rng = np.random.default_rng(11)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, H, Sq, hd), (B, K, Skv, hd), (B, K, Skv, hd))]
    offsets = np.full((B,), off, np.int32)
    ref = jax_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays),
                  causal=causal, q_offset=jnp.asarray(offsets))
    out = _tensor_core_emulation(
        *(torch.from_numpy(a).bfloat16() for a in arrays),
        torch.from_numpy(offsets), hd ** -0.5, causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hd,padded", [(16, 64), (64, 64), (112, 128),
                                        (128, 128)])
def test_head_dim_padding(hd, padded):
    assert ops._padded_hd(hd) == padded


def test_head_dim_above_kernel_raises():
    with pytest.raises(ValueError, match="head dim"):
        ops._padded_hd(256)


def test_cuda_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_fwd(q, q, q)
    assert kernel.launch_count() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, H, K, hd, dtype, q_offset, tol[, causal])
    (1, 1024, 1024, 36, 36, 64, torch.bfloat16, 0, 2e-2),   # minicpm prefill
    (2, 200, 200, 8, 2, 128, torch.bfloat16, 0, 2e-2),      # GQA, ragged tile
    (1, 33, 33, 4, 4, 64, torch.bfloat16, 0, 2e-2),         # below one tile
    (2, 96, 256, 4, 4, 64, torch.bfloat16, 160, 2e-2),      # q_offset, bf16
    (2, 96, 256, 4, 4, 64, torch.float32, 160, 1e-5),       # q_offset
    (1, 333, 333, 4, 4, 112, torch.float32, 0, 2e-6),       # fp32, padded hd
    # non-causal: whisper-large-v3's encoder, a cross-attention, GQA, a
    # ragged tile, an ignored q_offset, a padded hd
    (1, 1500, 1500, 20, 20, 64, torch.bfloat16, 0, 2e-2, False),
    (1, 1500, 1500, 20, 20, 64, torch.float32, 0, 2e-6, False),
    (1, 24, 150, 4, 2, 64, torch.bfloat16, 0, 2e-2, False),
    (2, 200, 200, 8, 2, 128, torch.bfloat16, 0, 2e-2, False),
    (1, 33, 33, 4, 4, 64, torch.bfloat16, 0, 2e-2, False),
    (2, 96, 256, 4, 4, 64, torch.float32, 160, 2e-6, False),
    (1, 333, 333, 4, 4, 112, torch.float32, 0, 2e-6, False),
])
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, Sq, Skv, H, K, hd, dtype, off, tol, *mode = case
    causal = mode[0] if mode else True
    q, k, v = (torch.from_numpy(a).to("cuda", dtype)
               for a in _mk_qkv(3, B, Sq, Skv, H, K, hd))
    q_offset = torch.full((B,), off, dtype=torch.int32, device="cuda")
    before = kernel.launch_count()
    out = ops.flash_attention(q, k, v, q_offset=q_offset, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launch_count() == before + 1
    plain = reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                q_offset=q_offset).transpose(1, 2)
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_kernel_refuses_bf16_head_dims_off_its_tiles():
    """hd 96 is no tile width of the tensor-core kernel: the wrapper raises
    before it builds or launches anything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q = torch.zeros(1, 2, 8, 96, dtype=torch.bfloat16, device="cuda")
    before = kernel.launch_count()
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention_fwd(q, q, q)
    assert kernel.launch_count() == before
