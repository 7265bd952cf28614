"""The port's SSD scan against the reference's, and its CUDA kernel against
its plain version.

On the CPU the port's wrapper runs its plain PyTorch version; the reference
runs both its ``ssd_reference`` and its Pallas kernel in interpret mode.
Inputs are made with numpy from a seed and handed to both, drawn as the
reference's own tests draw them.  Tolerances are the reference's
(tests/test_kernels.py): y 1e-4 in fp32 and 5e-2 in bf16, the final state
1e-3.  The CUDA kernel is held against the plain version on the card
(``cuda`` marker; ``python3 chip_smoke.py`` does the same at the serving
shapes).  The GPU machine has no JAX, so the reference is imported inside
the tests that use it and the ``cuda`` tests run there with
``--noconftest -m cuda``.  The bf16 CUDA kernel runs its heavy passes on
the tensor cores; their rounding points are rehearsed here on the CPU
(``_tensor_core_emulation``) against the reference at the bf16 tolerances.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import kernel, ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference

SHAPES = [                      # (Bt, S, H, P, N, chunk)
    (2, 64, 4, 8, 16, 16),
    (1, 50, 2, 16, 8, 16),      # padded last chunk
    (2, 128, 3, 8, 32, 64),
]
DTYPES = {"float32": (torch.float32, 1e-4), "bfloat16": (torch.bfloat16, 5e-2)}
STATE_TOL = 1e-3


def _inputs(seed, Bt, S, H, P, N, with_init=False):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(Bt, S, H, P)).astype(np.float32),
              rng.uniform(0.01, 0.2, size=(Bt, S, H)).astype(np.float32),
              -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
              rng.normal(size=(Bt, S, N)).astype(np.float32),
              rng.normal(size=(Bt, S, N)).astype(np.float32)]
    init = (rng.normal(size=(Bt, H, P, N)).astype(np.float32)
            if with_init else None)
    return arrays, init


def _torch(arrays, init, dtype, device="cpu"):
    x, dt, A, B, C = (torch.from_numpy(a).to(device) for a in arrays)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    init = None if init is None else torch.from_numpy(init).to(device)
    return (x, dt, A, B, C), init


def _jax_oracle(which, arrays, init, dtype_name, chunk):
    import jax.numpy as jnp
    from repro.kernels.ssd_scan.ops import ssd_scan as pallas_ssd
    from repro.kernels.ssd_scan.ref import ssd_reference as jax_ref
    jdt = getattr(jnp, dtype_name)
    x, dt, A, B, C = (jnp.asarray(a) for a in arrays)
    x, B, C = x.astype(jdt), B.astype(jdt), C.astype(jdt)
    ini = None if init is None else jnp.asarray(init)
    if which == "pallas_interpret":
        return pallas_ssd(x, dt, A, B, C, chunk=chunk, init_state=ini,
                          interpret=True)
    return jax_ref(x, dt, A, B, C, chunk=chunk, init_state=ini)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _tensor_core_emulation(x, dt, A, B, C, *, chunk, init_state=None,
                           split=True):
    """The bf16 tensor-core passes' arithmetic in plain PyTorch, chunk by
    chunk: C.B^T from bf16 inputs with fp32 sums; att = C.B^T * exp(cum_i -
    cum_j) * dt_j rounded to bf16 before att . x; the entering state rounded
    to bf16 before C . state; the summary x^T (w B) with w B split into a
    bf16 high part and the bf16 rounding of the rest (``split=False``: one
    bf16 rounding); y rounded to bf16, the state kept in fp32."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    xf, Bf, Cf = x.float(), B.float(), C.float()
    state = (torch.zeros(Bt, H, P, N) if init_state is None
             else init_state.float())
    y = torch.empty(Bt, S, H, P)
    for s0 in range(0, S, Q):
        L = min(Q, S - s0)
        xc, dtc = xf[:, s0:s0 + L], dt[:, s0:s0 + L]
        Bc, Cc = Bf[:, s0:s0 + L], Cf[:, s0:s0 + L]
        cum = torch.cumsum(dtc * A, dim=1)                          # (b,l,h)
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        mask = torch.ones(L, L, dtype=torch.bool).tril()[None, :, :, None]
        decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
        att = (cb[..., None] * decay * dtc[:, None]).bfloat16().float()
        y[:, s0:s0 + L] = (
            torch.einsum("bijh,bjhp->bihp", att, xc)
            + torch.einsum("bin,bhpn->bihp", Cc, state.bfloat16().float())
            * torch.exp(cum)[..., None])
        w = torch.exp(cum[:, -1:] - cum) * dtc
        wB = w[..., None] * Bc[:, :, None, :]                       # (b,l,h,n)
        hi = wB.bfloat16().float()
        summary = torch.einsum("bjhp,bjhn->bhpn", xc, hi)
        if split:
            summary += torch.einsum("bjhp,bjhn->bhpn", xc,
                                    (wB - hi).bfloat16().float())
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + summary
    return y.bfloat16(), state


# the serving shapes with 4 heads: (Bt, S, H, P, N, chunk, with init_state)
TC_CASES = {
    "mamba2": (1, 1024, 4, 64, 128, 256, False),
    "zamba2": (1, 1024, 4, 64, 64, 256, False),
    "padded": (2, 1000, 4, 64, 128, 256, False),
    "short": (1, 100, 4, 64, 128, 256, False),
    "init_state": (2, 300, 4, 64, 64, 128, True),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tensor_core_numerics_match_reference(case):
    """The bf16 passes' rounding points hold y to 5e-2 and the state to
    1e-3 of the reference on the same bf16 inputs."""
    Bt, S, H, P, N, Q, with_init = TC_CASES[case]
    arrays, init = _inputs(8, Bt, S, H, P, N, with_init)
    y_ref, fs_ref = _jax_oracle("ssd_reference", arrays, init, "bfloat16", Q)
    args, ini = _torch(arrays, init, torch.bfloat16)
    y, fs = _tensor_core_emulation(*args, chunk=Q, init_state=ini)
    _close(y, y_ref, 5e-2)
    _close(fs, fs_ref, STATE_TOL)


def test_one_bf16_rounding_of_wB_breaks_the_state_tolerance():
    """Why pass 1 splits w B into hi + lo: at the mamba2 shape (4 heads) a
    single bf16 rounding of w B errs on the final state by more than the
    reference's tolerance (1e-3 abs + rel); the split keeps it far inside.
    Run with ``-s`` to see both errors."""
    arrays, _ = _inputs(8, *TC_CASES["mamba2"][:5])
    _, fs_ref = _jax_oracle("ssd_reference", arrays, None, "bfloat16", 256)
    fs_ref = _f32(fs_ref)
    args, _ = _torch(arrays, None, torch.bfloat16)
    share = {}
    for split in (True, False):
        _, fs = _tensor_core_emulation(*args, chunk=256, split=split)
        err = np.abs(_f32(fs) - fs_ref)
        share[split] = float((err / (STATE_TOL + STATE_TOL * np.abs(fs_ref))).max())
        print(f"state max_abs_err, w B {'split' if split else 'rounded once'}: "
              f"{err.max():.3g} ({share[split]:.3g} of the tolerance)")
    assert share[True] < 0.1 < 1.0 < share[False]


@pytest.mark.parametrize("P,N,ok", [(64, 128, True), (64, 64, True),
                                    (16, 16, True), (64, 256, True),
                                    (8, 16, False), (64, 72, False),
                                    (80, 128, False), (64, 272, False)])
def test_tensor_core_shape_constraints(P, N, ok):
    if ok:
        kernel.check_tensor_core_shape(P, N)
    else:
        with pytest.raises(ValueError, match="multiples of 16"):
            kernel.check_tensor_core_shape(P, N)


@pytest.mark.parametrize("oracle", ["ssd_reference", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_scan_matches_reference(dtype, shape, oracle):
    Bt, S, H, P, N, Q = shape
    tdt, tol = DTYPES[dtype]
    arrays, _ = _inputs(0, Bt, S, H, P, N)
    y_ref, fs_ref = _jax_oracle(oracle, arrays, None, dtype, Q)
    (x, dt, A, B, C), _ = _torch(arrays, None, tdt)
    y, fs = ops.ssd_scan(x, dt, A, B, C, chunk=Q)
    assert y.shape == (Bt, S, H, P) and y.dtype == tdt
    assert fs.shape == (Bt, H, P, N) and fs.dtype == torch.float32
    _close(y, y_ref, tol)
    _close(fs, fs_ref, STATE_TOL)


@pytest.mark.parametrize("oracle", ["ssd_reference", "pallas_interpret"])
def test_ssd_scan_init_state(oracle):
    arrays, init = _inputs(1, 1, 32, 2, 4, 8, with_init=True)
    y_ref, fs_ref = _jax_oracle(oracle, arrays, init, "float32", 16)
    (x, dt, A, B, C), ini = _torch(arrays, init, torch.float32)
    y, fs = ops.ssd_scan(x, dt, A, B, C, chunk=16, init_state=ini)
    _close(y, y_ref, 1e-4)
    _close(fs, fs_ref, STATE_TOL)


def test_short_prompt_takes_one_chunk_of_its_length():
    """S = 100 < chunk = 256 gives Q = 100, as the reference does."""
    arrays, _ = _inputs(2, 1, 100, 2, 16, 32)
    y_ref, fs_ref = _jax_oracle("ssd_reference", arrays, None, "float32", 256)
    (x, dt, A, B, C), _ = _torch(arrays, None, torch.float32)
    y, fs = ops.ssd_scan(x, dt, A, B, C, chunk=256)
    _close(y, y_ref, 1e-4)
    _close(fs, fs_ref, STATE_TOL)


def test_ssd_streaming_equals_one_shot():
    """Two half-sequence calls chained by state equal one full call (the
    serving path relies on this)."""
    arrays, _ = _inputs(3, 1, 64, 2, 8, 16)
    (x, dt, A, B, C), _ = _torch(arrays, None, torch.float32)
    y_full, fs_full = ops.ssd_scan(x, dt, A, B, C, chunk=16)
    h = 32
    y1, s1 = ops.ssd_scan(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h], chunk=16)
    y2, s2 = ops.ssd_scan(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:],
                          chunk=16, init_state=s1)
    _close(torch.cat([y1, y2], dim=1), y_full, 1e-4)
    _close(s2, fs_full, 1e-4)


def test_padding_steps_are_no_ops():
    """Steps with dt = 0 leave the state where it was: appending them
    changes neither the prefix's outputs nor the final state."""
    arrays, _ = _inputs(4, 1, 40, 2, 8, 16)
    (x, dt, A, B, C), _ = _torch(arrays, None, torch.float32)
    y, fs = ops.ssd_scan(x, dt, A, B, C, chunk=16)
    pad = lambda t: torch.cat([t, torch.randn_like(t[:, :8])], dim=1)
    dt_p = torch.cat([dt, torch.zeros_like(dt[:, :8])], dim=1)
    y_p, fs_p = ops.ssd_scan(pad(x), dt_p, A, pad(B), pad(C), chunk=16)
    _close(y_p[:, :40], y, 1e-6)
    _close(fs_p, fs, 1e-6)


def test_cuda_kernel_refuses_cpu_tensors():
    (x, dt, A, B, C), _ = _torch(_inputs(5, 1, 8, 2, 4, 4)[0], None,
                                 torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.ssd_scan_fwd(x, dt, A, B, C, chunk=4)
    assert kernel.launch_count() == 0


class _Elsewhere(torch.Tensor):
    """A tensor that says it lies on a device the port does not run on."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a refused device")


def test_ops_refuses_other_devices():
    """cuda runs the kernel, cpu the plain version, and meta (a dry run's
    shapes) the plain version too, launching nothing; any other device is
    refused before anything runs."""
    shapes = ((1, 8, 2, 4), (1, 8, 2), (2,), (1, 8, 4))
    x, dt, A, B = (_Elsewhere(s) for s in shapes)
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        ops.ssd_scan(x, dt, A, B, B, chunk=4)
    x, dt, A, B = (torch.zeros(s, device="meta") for s in shapes)
    y, state = ops.ssd_scan(x, dt, A, B, B, chunk=4)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 8, 2, 4)
    assert tuple(state.shape) == (1, 2, 4, 4)


# (Bt, S, H, P, N, chunk, dtype, with init_state, y tol)
CUDA_CASES = {
    "mamba2": (1, 1024, 32, 64, 128, 256, torch.bfloat16, False, 5e-2),
    "zamba2": (1, 1024, 64, 64, 64, 256, torch.bfloat16, False, 5e-2),
    "padded": (2, 1000, 4, 64, 128, 256, torch.float32, False, 1e-4),
    "padded_bf16": (2, 1000, 4, 64, 128, 256, torch.bfloat16, False, 5e-2),
    "short_bf16": (1, 100, 4, 64, 128, 256, torch.bfloat16, False, 5e-2),
    "init_state_bf16": (2, 300, 3, 32, 64, 128, torch.bfloat16, True, 5e-2),
    "short": (1, 100, 4, 64, 128, 256, torch.float32, False, 1e-4),
    "init_state": (2, 300, 3, 32, 64, 128, torch.float32, True, 1e-4),
    "small_p_n": (2, 50, 4, 8, 16, 16, torch.float32, True, 1e-4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Bt, S, H, P, N, Q, dtype, with_init, tol = CUDA_CASES[case]
    arrays, init = _inputs(6, Bt, S, H, P, N, with_init)
    args, ini = _torch(arrays, init, dtype, "cuda")
    before = kernel.launch_count()
    y, fs = ops.ssd_scan(*args, chunk=Q, init_state=ini)
    torch.cuda.synchronize()
    assert kernel.launch_count() == before + 1
    y_ref, fs_ref = ssd_reference(*args, chunk=Q, init_state=ini)
    assert y.dtype == dtype and bool(torch.isfinite(y.float()).all())
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(fs, fs_ref, rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.cuda
def test_cuda_kernel_chained_halves_equal_one_call():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    arrays, _ = _inputs(7, 1, 1024, 8, 64, 128)
    (x, dt, A, B, C), _ = _torch(arrays, None, torch.float32, "cuda")
    y_full, fs_full = ops.ssd_scan(x, dt, A, B, C, chunk=256)
    h = 512
    y1, s1 = ops.ssd_scan(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h],
                          chunk=256)
    y2, s2 = ops.ssd_scan(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:],
                          chunk=256, init_state=s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, fs_full, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_kernel_chained_halves_bf16():
    """The tensor-core passes: two chained calls against one, at the bf16
    tolerances (y 5e-2, state 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    arrays, _ = _inputs(9, 1, 1024, 8, 64, 128)
    (x, dt, A, B, C), _ = _torch(arrays, None, torch.bfloat16, "cuda")
    y_full, fs_full = ops.ssd_scan(x, dt, A, B, C, chunk=256)
    h = 512
    y1, s1 = ops.ssd_scan(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h],
                          chunk=256)
    y2, s2 = ops.ssd_scan(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:],
                          chunk=256, init_state=s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y1, y2], dim=1).float(),
                               y_full.float(), rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(s2, fs_full, rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.cuda
def test_cuda_kernel_refuses_bf16_shapes_off_the_tensor_cores():
    """P = 8 is no multiple of the mma tile: the wrapper raises before it
    builds or launches anything (fp32 takes the same shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    args, _ = _torch(_inputs(10, 1, 50, 4, 8, 16)[0], None, torch.bfloat16,
                     "cuda")
    before = kernel.launch_count()
    with pytest.raises(ValueError, match="multiples of 16"):
        kernel.ssd_scan_fwd(*args, chunk=16)
    assert kernel.launch_count() == before
