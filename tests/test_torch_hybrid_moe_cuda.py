"""The kernels the ``hybrid_moe`` family adds or widens, on the card
(``cuda`` marker; they skip elsewhere), against their plain versions:
the SSD kernel with B/C in G groups (nemotron-3-nano-30b-a3b's G = 8, H =
64, N = 128, and a small group of 2 heads), at ``test_torch_ssd_scan.py``'s
tolerances (y 5e-2 in bf16 and 1e-4 in fp32, the state 1e-3); and the
grouped relu^2 expert kernels at the model's widths and at a small size.
The file imports no JAX, so it runs where only PyTorch is installed."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_grouped import kernel as moe_kernel
from repro_torch.kernels.moe_grouped.ops import grouped_relu2
from repro_torch.kernels.moe_grouped.ref import grouped_relu2 as moe_plain
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference

STATE_TOL = 1e-3

# (Bt, S, H, P, N, G, chunk, dtype, with init_state, y tol)
SSD_CASES = {
    "nemotron_bf16": (1, 512, 64, 64, 128, 8, 128, torch.bfloat16, False, 5e-2),
    "nemotron_init_bf16": (2, 300, 64, 64, 128, 8, 128, torch.bfloat16, True,
                           5e-2),
    "nemotron_fp32": (1, 300, 64, 64, 128, 8, 128, torch.float32, False, 1e-4),
    "nemotron_init_fp32": (2, 200, 64, 64, 128, 8, 128, torch.float32, True,
                           1e-4),
    "two_heads_a_group_bf16": (2, 150, 8, 64, 64, 4, 64, torch.bfloat16, True,
                               5e-2),
    "two_heads_a_group_fp32": (2, 150, 8, 32, 16, 4, 64, torch.float32, True,
                               1e-4),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_grouped_ssd_kernel_matches_plain(case):
    dev = _card()
    Bt, S, H, P, N, G, Q, dtype, with_init, tol = SSD_CASES[case]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(Bt, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bt, S, H)).astype(np.float32))
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(Bt, S, G, N)).astype(np.float32))
    C = torch.from_numpy(rng.normal(size=(Bt, S, G, N)).astype(np.float32))
    init = (torch.from_numpy(rng.normal(size=(Bt, H, P, N)).astype(np.float32))
            .to(dev) if with_init else None)
    x, B, C = (t.to(dev, dtype) for t in (x, B, C))
    dt, A = dt.to(dev), A.to(dev)
    before = ssd_kernel.launch_count()
    y, fs = ssd_ops.ssd_scan(x, dt, A, B, C, chunk=Q, init_state=init)
    torch.cuda.synchronize()
    assert ssd_kernel.launch_count() == before + 1
    y_ref, fs_ref = ssd_reference(x, dt, A, B, C, chunk=Q, init_state=init)
    assert y.dtype == dtype and bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(fs, fs_ref, rtol=STATE_TOL, atol=STATE_TOL)


def _moe_inputs(n, k, E, D, F, dtype, dev, seed=3, skew=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, D, generator=g)
    wu = torch.randn(E, D, F, generator=g) / D ** 0.5
    wd = torch.randn(E, F, D, generator=g) / F ** 0.5
    if skew:                    # every token on the same k experts
        ids = torch.arange(k).repeat(n)
    else:
        ids = torch.stack([torch.randperm(E, generator=g)[:k]
                           for _ in range(n)]).reshape(-1)
    order = torch.argsort(ids, stable=True)
    counts = torch.bincount(ids, minlength=E)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long), counts.cumsum(0)])
    scale = torch.rand(n * k, generator=g)[order]
    args = (x.to(dtype), order // k, order, scale, offsets, wu.to(dtype),
            wd.to(dtype))
    return tuple(t.to(dev) for t in args)


# (tokens, k, experts, D, F, dtype, skewed, tol relative to the largest)
MOE_CASES = {
    "decode_bf16": (64, 6, 128, 2688, 1856, torch.bfloat16, False, 2e-2),
    "prefill_bf16": (192, 6, 128, 2688, 1856, torch.bfloat16, False, 2e-2),
    "long_prefill_bf16": (600, 6, 128, 2688, 1856, torch.bfloat16, False, 2e-2),
    "skewed_bf16": (300, 6, 128, 256, 192, torch.bfloat16, True, 2e-2),
    "small_fp32": (37, 2, 8, 64, 48, torch.float32, False, 1e-5),
    "skewed_fp32": (70, 3, 8, 40, 24, torch.float32, True, 1e-5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_grouped_expert_kernel_matches_plain(case):
    dev = _card()
    n, k, E, D, F, dtype, skew, tol = MOE_CASES[case]
    args = _moe_inputs(n, k, E, D, F, dtype, dev, skew=skew)
    before = moe_kernel.launch_count()
    out = grouped_relu2(*args)
    torch.cuda.synchronize()
    assert moe_kernel.launch_count() == before + 1
    want = moe_plain(*args)
    assert out.dtype == torch.float32 and out.shape == (n * k, D)
    scale = float(want.abs().max())
    err = float((out - want).abs().max())
    assert err <= tol * scale, (err, scale)
