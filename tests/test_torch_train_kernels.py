"""The port's flash-attention and SSD-scan ops under autograd, against the
reference's ``custom_vjp`` ops.

Both ops are ``torch.autograd.Function``s whose backward recomputes through
the plain version, as the reference's backward recomputes through its
pure-jnp one.  On the CPU the port's forward is the plain version; the
reference runs its Pallas kernel in interpret mode, as its own tests run it
(tests/test_kernels.py).  Inputs are made with numpy from a seed and handed
to both.  Outputs and every input's gradient agree within 1e-4 (the
reference's own gradient tolerance, tests/test_kernels.py:55-75), in fp32.
On the card (``cuda`` marker) the kernel's forward and the gradients
through it are held against autograd through the plain version; JAX is
imported only inside the tests that use it, since the GPU machine has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference

TOL = 1e-4

FLASH_CASES = [                 # (B, Sq, Skv, H, K, hd, q_offset, causal)
    (1, 64, 64, 4, 4, 32, 0, True),     # MHA
    (2, 48, 48, 4, 2, 16, 0, True),     # GQA
    (1, 32, 64, 2, 2, 16, 32, True),    # q_offset: the block starts at 32
    (1, 40, 40, 2, 2, 112, 0, True),    # hd 112, padded to 128 in the forward
    # non-causal: every key visible, q_offset ignored
    (1, 64, 64, 4, 4, 32, 0, False),    # MHA
    (2, 48, 48, 4, 2, 16, 0, False),    # GQA
    (1, 24, 150, 4, 2, 64, 0, False),   # cross-attention, ragged Skv
    (1, 32, 64, 2, 2, 16, 32, False),   # an offset that plays no part
    (1, 40, 40, 2, 2, 112, 0, False),   # hd 112
]
FLASH_IDS = ["mha", "gqa", "q_offset", "hd112", "mha-noncausal",
             "gqa-noncausal", "cross-noncausal", "q_offset-noncausal",
             "hd112-noncausal"]


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _flash_inputs(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd),
                      (B, Sq, H, hd))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=FLASH_IDS)
def test_flash_attention_grads_match_reference(case):
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention as jflash
    B, Sq, Skv, H, K, hd, off, causal = case
    q, k, v, w = _flash_inputs(3, B, Sq, Skv, H, K, hd)
    offset = np.full((B,), off, np.int32)

    def jloss(q, k, v):
        out = jflash(q, k, v, q_offset=jnp.asarray(offset), causal=causal,
                     interpret=True, block_q=16, block_k=16)
        return jnp.sum(out * w), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, q_offset=torch.from_numpy(offset),
                              causal=causal)
    assert out.shape == (B, Sq, H, hd)
    torch.sum(out * torch.from_numpy(w)).backward()
    _close(out.detach(), jout)
    for got, want, t in zip((tq.grad, tk.grad, tv.grad), jgrads, (q, k, v)):
        assert got.shape == t.shape       # the hd padding does not leak
        _close(got, want)


def test_flash_attention_grad_is_the_plain_versions():
    """The backward is autograd through the plain version, bit for bit."""
    q, k, v, w = _flash_inputs(4, 2, 24, 24, 4, 2, 16)
    grads = []
    for fn in (lambda q, k, v: ops.flash_attention(q, k, v),
               lambda q, k, v: reference_attention(
                   q.transpose(1, 2), k.transpose(1, 2),
                   v.transpose(1, 2)).transpose(1, 2)):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        torch.sum(fn(*ts) * torch.from_numpy(w)).backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _ssd_inputs(seed, Bt, S, H, P, N, with_init):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(Bt, S, H, P)).astype(np.float32),
              rng.uniform(0.01, 0.2, size=(Bt, S, H)).astype(np.float32),
              -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
              rng.normal(size=(Bt, S, N)).astype(np.float32),
              rng.normal(size=(Bt, S, N)).astype(np.float32),
              rng.normal(size=(Bt, H, P, N)).astype(np.float32)]
    weights = (rng.normal(size=(Bt, S, H, P)).astype(np.float32),
               rng.normal(size=(Bt, H, P, N)).astype(np.float32))
    return arrays if with_init else arrays[:5], weights


@pytest.mark.parametrize("with_init", [False, True],
                         ids=["zero_state", "init_state"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 8, 16, 16),
                                   (1, 50, 2, 16, 8, 16)],
                         ids=["even", "padded"])
def test_ssd_scan_grads_match_reference(shape, with_init):
    """y, the final state and the gradients of x, dt, A, B, C (and
    init_state) through both outputs against ``jax.vjp`` of the reference's
    op in interpret mode."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as jssd
    Bt, S, H, P, N, chunk = shape
    arrays, (wy, ws) = _ssd_inputs(5, Bt, S, H, P, N, with_init)

    def jfn(x, dt, A, B, C, *init):
        return jssd(x, dt, A, B, C, chunk=chunk,
                    init_state=init[0] if init else None, interpret=True)
    (jy, js), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in arrays))
    jgrads = vjp((jnp.asarray(wy), jnp.asarray(ws)))

    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, state = ssd_ops.ssd_scan(*ts[:5], chunk=chunk,
                                init_state=ts[5] if with_init else None)
    torch.autograd.backward((y, state), (torch.from_numpy(wy),
                                         torch.from_numpy(ws)))
    _close(y.detach(), jy)
    _close(state.detach(), js, 1e-3)          # the reference's state tol
    assert len(jgrads) == len(ts)
    for t, want in zip(ts, jgrads):
        assert t.grad.shape == t.shape
        _close(t.grad, want)


def test_ssd_scan_final_state_alone_is_differentiable():
    """A loss on the final state only (y's gradient zero) reaches x, dt,
    A, B and init_state as autograd through the plain version does; C,
    which only y reads, gets a zero gradient."""
    arrays, (_, ws) = _ssd_inputs(6, 1, 40, 2, 8, 8, True)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    _, state = ssd_ops.ssd_scan(*ts[:5], chunk=16, init_state=ts[5])
    torch.sum(state * torch.from_numpy(ws)).backward()
    ref = [torch.from_numpy(a).requires_grad_() for a in arrays]
    _, want = ssd_reference(*ref[:5], chunk=16, init_state=ref[5])
    torch.sum(want * torch.from_numpy(ws)).backward()
    assert ref[4].grad is None and not ts[4].grad.any()
    for t, r in zip(ts[:4] + ts[5:], ref[:4] + ref[5:]):
        assert torch.equal(t.grad, r.grad)


def test_integer_q_offset_takes_no_gradient():
    q, k, v, _ = _flash_inputs(7, 1, 8, 16, 2, 2, 16)
    off = torch.full((1,), 8, dtype=torch.int32)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*ts, q_offset=off).sum().backward()
    assert off.grad is None and all(t.grad is not None for t in ts)


# ---------------------------------------------------------------------------
# On the card: the kernels' forward under autograd, gradients through them
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol,grad_tol,causal", [
    (torch.float32, 2e-6, 1e-4, True), (torch.bfloat16, 2e-2, 5e-2, True),
    (torch.float32, 2e-6, 1e-4, False), (torch.bfloat16, 2e-2, 5e-2, False)],
    ids=["fp32", "bf16", "fp32-noncausal", "bf16-noncausal"])
def test_cuda_flash_grads_match_plain(dtype, tol, grad_tol, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, w = _flash_inputs(8, 2, 200, 200, 8, 2, 64)
    got, want = [], []
    for fn, sink in ((ops.flash_attention, got), (None, want)):
        ts = [torch.from_numpy(a).to("cuda", dtype).requires_grad_()
              for a in (q, k, v)]
        out = fn(*ts, causal=causal) if fn else reference_attention(
            *(t.transpose(1, 2) for t in ts), causal=causal).transpose(1, 2)
        torch.sum(out.float() * torch.from_numpy(w).cuda()).backward()
        sink.extend([out.detach()] + [t.grad for t in ts])
    _close(got[0].float().cpu(), want[0].float().cpu(), tol)
    for a, b in zip(got[1:], want[1:]):
        _close(a.float().cpu(), b.float().cpu(), grad_tol)


@pytest.mark.cuda
def test_cuda_ssd_grads_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays, (wy, ws) = _ssd_inputs(9, 2, 300, 4, 64, 64, True)
    got, want = [], []
    for fn, sink in ((ssd_ops.ssd_scan, got), (ssd_reference, want)):
        ts = [torch.from_numpy(a).cuda().requires_grad_() for a in arrays]
        y, s = fn(*ts[:5], chunk=128, init_state=ts[5])
        torch.autograd.backward((y, s), (torch.from_numpy(wy).cuda(),
                                         torch.from_numpy(ws).cuda()))
        sink.extend([y.detach(), s.detach()] + [t.grad for t in ts])
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.cpu(), b.cpu(), 1e-3 if i == 1 else TOL)
