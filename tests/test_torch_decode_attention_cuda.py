"""The split-KV decode-attention kernel on the card (``cuda`` marker; they
skip elsewhere), against its plain version
(``kernels/decode_attention/ref.py``, which is ``_mha_dense``'s arithmetic
for one query): in bf16 within 2e-3 abs + 1e-2 rel (a tenth of flash's
bf16 tolerance in abs, and a tenth of a typical output value at the cells'
lengths, where the softmax spreads over about a thousand keys), and within
1e-5 in fp32, at every (head width, GQA group) the port decodes with and at
the three cells' shapes, in both dtypes; lengths on and around the split boundaries; a cache
read only below each length (what lies past it is NaN); a strided cache; a
launch captured in a CUDA graph and replayed with new lengths, equal to
the eager call; the launch count; and the shapes it refuses.  The file
imports no JAX, so it runs where only PyTorch is installed."""

import pytest
import torch

from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import \
    reference_decode_attention

# (atol, rtol) by dtype
TOLS = {torch.bfloat16: (2e-3, 1e-2), torch.float32: (1e-5, 1e-5)}

# (B, S_max, H, K, hd): each configuration's decode attention at a small
# batch and cache, then the cells' own
SHAPES = {
    "minicpm_hd64": (3, 300, 36, 36, 64),
    "whisper_decoder": (3, 300, 20, 20, 64),
    "zamba2_shared": (3, 300, 32, 32, 64),
    "phi3v_hd96": (3, 300, 32, 32, 96),
    "kimi_hd112_gqa8": (3, 300, 64, 8, 112),
    "minitron_gqa3": (3, 300, 24, 8, 128),
    "qwen25_gqa5": (3, 300, 40, 8, 128),
    "qwen2_72b_gqa8": (3, 300, 64, 8, 128),
    "moonshot_mha": (3, 300, 16, 16, 128),
    "nemotron_gqa16": (3, 300, 32, 2, 128),
    "gqa2_in_a_block_of_4": (3, 300, 8, 4, 128),
    "gqa_wider_than_a_block": (2, 300, 48, 2, 64),
    "minicpm_long_prompt_cell": (16, 4136, 36, 36, 64),
    "minicpm_long_output_cell": (16, 1544, 36, 36, 64),
    "nemotron_long_output_cell": (64, 1544, 32, 2, 128),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, S, H, K, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, K, hd, generator=g, device=dev).to(dtype)
    lens = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    lens[0] = S                     # one full, one of a single key
    lens[-1] = 1
    return q, k, v, lens


def _check(out, q, k, v, lens):
    want = reference_decode_attention(q, k, v, lens)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    atol, rtol = TOLS[q.dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "fp32"))
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_kernel_matches_plain(case, dtype):
    dev = _card()
    q, k, v, lens = _inputs(dev, *SHAPES[case], dtype)
    before = kernel.launch_count()
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert kernel.launch_count() == before + 1
    _check(out, q, k, v, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("G", (1, 16))
def test_lengths_around_the_split_boundaries(G):
    dev = _card()
    B, S, K, hd = 16, 4136, 36 // G if G == 1 else 2, 64 if G == 1 else 128
    q, k, v, _ = _inputs(dev, B, S, G * K, K, hd, torch.bfloat16, seed=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, nsplit, chunk = kernel.split_plan(B, K, G, S, sms)
    assert nsplit > 1
    edges = [1, kernel.TILE - 1, kernel.TILE, kernel.TILE + 1, chunk - 1,
             chunk, chunk + 1, 2 * chunk - 1, 2 * chunk, 2 * chunk + 1,
             (nsplit - 1) * chunk, (nsplit - 1) * chunk + 1, S - 1, S, S, 7]
    lens = torch.tensor(edges[:B], device=dev)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    _check(out, q, k, v, lens)


@pytest.mark.cuda
def test_nothing_past_a_length_is_read():
    """A free slot keeps its stale length and reads up to it; what lies
    past any slot's length (here NaN) must not reach the output."""
    dev = _card()
    q, k, v, lens = _inputs(dev, 8, 1544, 36, 36, 64, torch.bfloat16, seed=2)
    lens = torch.tensor([1, 31, 33, 224, 700, 1000, 1543, 1544], device=dev)
    clean_k, clean_v = k.clone(), v.clone()
    pos = torch.arange(1544, device=dev)
    past = (pos[None, :] >= lens[:, None])[:, :, None, None]
    k.masked_fill_(past, float("nan"))
    v.masked_fill_(past, float("nan"))
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    _check(out, q, clean_k, clean_v, lens)


@pytest.mark.cuda
def test_a_strided_cache_is_read_in_place():
    """The kernel takes the cache through its strides: one layer of a
    stacked (L, B, S, K, hd) cache, and K heads picked out of wider rows."""
    dev = _card()
    B, S, H, K, hd = 4, 600, 16, 4, 128
    g = torch.Generator(device=dev).manual_seed(3)
    stack = torch.randn(3, B, S, K + 2, hd, generator=g, device=dev).to(
        torch.bfloat16)
    k, v = stack[1, :, :, :K], stack[2, :, :, 2:]
    assert not k.is_contiguous()
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor([600, 1, 257, 31], device=dev)
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    _check(out, q, k.contiguous(), v.contiguous(), lens)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("minicpm_long_output_cell",
                                  "nemotron_gqa16"))
def test_a_captured_launch_replays_with_new_lengths(case):
    dev = _card()
    q, k, v, lens = _inputs(dev, *SHAPES[case], torch.bfloat16, seed=4)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            decode_attention(q, k, v, lens)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = decode_attention(q, k, v, lens)
    S = k.shape[1]
    for seed in range(3):
        g = torch.Generator(device=dev).manual_seed(10 + seed)
        lens.copy_(torch.randint(1, S + 1, lens.shape, generator=g,
                                 device=dev))
        q.copy_(torch.randn(q.shape, generator=g, device=dev))
        graph.replay()
        eager = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        _check(out, q, k, v, lens)


@pytest.mark.cuda
def test_refuses_what_it_does_not_take():
    dev = _card()
    q, k, v, lens = _inputs(dev, 2, 64, 4, 4, 80, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 80"):
        decode_attention(q, k, v, lens)
    q, k, v, lens = _inputs(dev, 2, 64, 4, 4, 64, torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(q, k, v, lens)
    q, k, v, lens = _inputs(dev, 2, 64, 4, 4, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="unit last stride"):
        decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, lens)
    with pytest.raises(ValueError, match="one query"):
        decode_attention(torch.cat([q, q], dim=1), k, v, lens)
