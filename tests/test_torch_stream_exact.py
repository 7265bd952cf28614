"""The port's stream operators bit for bit against the reference's.

The reference's operator bodies (``repro/runtime/operators.py``) are
jitted on JAX's CPU, where XLA rounds ``x * 1.000001 + 0.5`` once (a fused
multiply-add), sums more than 32 values in windows of 32, scans more than
16 in tiles of 16, and takes ``%`` as ``fmod`` plus a sign fix-up.  The
port's plain versions (``kernels/stream_ops/ref.py``, the CPU path of
every operator and the oracle of the CUDA kernels) follow each of these,
so every output is compared with ``assert_array_equal``: the service and
the digest at every part size tested, negative columns included.

The CUDA service kernel shortens the chain after its first step (the
Sterbenz identity) and the pi kernel halves by multiplying; both are
checked here in numpy over every float32 value they can meet.  The
kernels are held against the plain versions on the card, to 0, by
``tests/test_torch_stream_ops.py::test_cuda_kernels_match_plain`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.stream_ops import ref as so_ref
from repro_torch.runtime import operators as port_operators

SEEDS = range(10)
SERVICE_PARTS = (1, 7, 16, 32, 33, 64, 100, 1024, 1025)
DIGEST_PARTS = (1, 7, 16, 17, 32, 33, 64, 256, 257, 1024)


def ref_operators():
    from repro.runtime import operators
    return operators


def jit_ref(fn):
    """The reference's ``fn`` jitted on JAX's CPU once, taking and
    returning numpy batches."""
    import jax
    import jax.numpy as jnp
    jitted = jax.jit(fn)

    def run(batch):
        out = jitted({k: jnp.asarray(v) for k, v in batch.items()})
        return {k: np.asarray(v) for k, v in out.items()}
    return run


def run_port(kind, batch):
    op = port_operators.make_operator(kind, "cpu")
    out = op({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return {k: v.numpy() for k, v in out.items()}


def values(B, seed, kind="uniform"):
    """A float32 column: SyntheticSource's values in [0, 1), a wide signed
    one, or one spread over many binades with both signs."""
    rng = np.random.default_rng(1000 * seed + B)
    if kind == "uniform":
        return rng.random(B, dtype=np.float32)
    if kind == "signed":
        return (rng.standard_normal(B) * 1e3).astype(np.float32)
    sign = np.where(rng.random(B) < 0.4, -1.0, 1.0)
    return (np.exp(rng.standard_normal(B) * 4) * sign).astype(np.float32)


def assert_equal_outputs(port, ref, key):
    assert port[key].dtype == np.float32
    np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


@pytest.mark.parametrize("B", (1, 7, 16, 32))
@pytest.mark.parametrize("kind", ("azure_blob", "azure_table"))
def test_service_equals_reference_up_to_a_warp(kind, B):
    ref = jit_ref(ref_operators().OPERATORS[kind])
    for seed in SEEDS:
        part = {"value": values(B, seed)}
        assert_equal_outputs(run_port(kind, part), ref(part), "service")


@pytest.mark.parametrize("B", SERVICE_PARTS)
@pytest.mark.parametrize("spread", ("signed", "wide"))
def test_service_equals_reference_in_xla_windows(B, spread):
    """Parts past 32 are summed in XLA's windows of 32, negatives too."""
    ref = jit_ref(ref_operators()._op_external_service)
    for seed in range(4):
        part = {"value": values(B, seed, spread)}
        assert_equal_outputs(run_port("azure_blob", part), ref(part),
                             "service")


@pytest.mark.parametrize("column, work, want", [
    ([-3.25, -1.5, 0.125], 64, None),
    ([-3.25, -1.5, 0.125], 1, None),
    ([-0.5], 64, None),           # the first multiply-add is exactly 0
    ([-1000.5, 0.0], 2, None),
    ([8.261722] * 16, 64, None),
    ([0.0], 0, 0.0),
])
def test_service_edges_equal_reference(column, work, want):
    v = np.array(column, dtype=np.float32)
    ref = jit_ref(lambda b: ref_operators()._op_external_service(
        b, work=work))({"value": v})["service"]
    got = so_ref.external_service_reference(torch.from_numpy(v), work)
    np.testing.assert_array_equal(got.numpy(), ref)
    if want is not None:
        assert got.tolist() == [want] * len(column)


def test_service_negative_part_takes_jax_remainder():
    """fmod alone would leave the first remainder negative."""
    v = np.array([-3.25, -1.5, 0.125], dtype=np.float32)
    ref = jit_ref(ref_operators()._op_external_service)({"value": v})
    got = so_ref.external_service_reference(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, ref["service"])
    assert got[0] == np.float32(27.384485)


@pytest.mark.parametrize("B", DIGEST_PARTS)
def test_digest_equals_reference_on_values(B):
    ref = jit_ref(ref_operators()._op_batch_file_write)
    for seed, spread in zip(range(6), ("uniform", "signed", "wide") * 2):
        part = {"value": values(B, seed, spread)}
        assert_equal_outputs(run_port("batch_file_write", part), ref(part),
                             "digest")


@pytest.mark.parametrize("B", DIGEST_PARTS)
def test_digest_equals_reference_on_checksums(B):
    """The integer column: parse_xml's checksums (non-negative, uint32 in
    the reference) and signed int32 columns past 2**24 in their sums."""
    ref = jit_ref(ref_operators()._op_batch_file_write)
    for seed in range(4):
        rng = np.random.default_rng(seed + B)
        payload = rng.integers(32, 127, size=(B, 256), dtype=np.uint8)
        checksum = payload.astype(np.uint32).sum(axis=1, dtype=np.uint32)
        port = run_port("batch_file_write",
                        {"checksum": checksum.astype(np.int32)})
        assert_equal_outputs(port, ref({"checksum": checksum}), "digest")
        signed = rng.integers(-(2 ** 22), 2 ** 22, size=B, dtype=np.int32)
        assert_equal_outputs(run_port("batch_file_write", {"checksum": signed}),
                             ref({"checksum": signed}), "digest")


def test_digest_of_negative_integers_takes_jax_remainder():
    x = np.array([-3, -1], dtype=np.int32)
    ref = jit_ref(ref_operators()._op_batch_file_write)({"checksum": x})
    got = so_ref.rolling_digest_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref["digest"])
    assert got.tolist() == [65518.0, 65517.0]


@pytest.mark.parametrize("n", (1, 16, 17, 33, 256, 257, 1024, 4097))
def test_xla_cumsum_blocks(n):
    """The blocked scan's association, checked on values whose sums are
    exact (integers): every prefix is the running total."""
    v = torch.arange(1, n + 1, dtype=torch.float32)
    assert torch.equal(so_ref.xla_cumsum(v), torch.cumsum(v, 0))


def _fma_f32(x, mul, add):
    """numpy float32 fused multiply-add: the float64 sum rounded to odd,
    then to float32 (as ref.fma_f32)."""
    p = x.astype(np.float64) * np.float64(mul)
    s = p + np.float64(add)
    err = (np.float64(add) - s) + p
    odd = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
    s = np.where((err != 0) & ((s.view(np.int64) & 1) == 0), odd, s)
    return s.astype(np.float32)


def _jax_mod(y, m):
    r = np.fmod(y, np.float32(m))
    return np.where(r < 0, r + np.float32(m), r).astype(np.float32)


def test_fma_f32_rounds_once():
    """The plain version's fused multiply-add against an exact rational
    reference on a mix of keys."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    xs = np.concatenate([
        (rng.standard_normal(3000) * 10.0 ** rng.integers(-12, 8, 3000)),
        [0.0, -0.5, -0.4999999, 1000.0, 999.5, 2.0 ** -30, -2.0 ** -30]
    ]).astype(np.float32)
    mul = np.float32(so_ref.SERVICE_MUL)
    got = so_ref.fma_f32(torch.from_numpy(xs),
                         torch.tensor(float(mul), dtype=torch.float64),
                         torch.tensor(0.5, dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got, _fma_f32(xs, mul, 0.5))
    for x, g in zip(xs[::7], got[::7]):
        exact = Fraction(float(x)) * Fraction(float(mul)) + Fraction(1, 2)
        below = np.float32(float(exact))
        cands = {below, np.nextafter(below, np.float32(np.inf)),
                 np.nextafter(below, np.float32(-np.inf))}
        best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                         int(np.array(c).view(np.int32)) & 1))
        assert g == best, (x, g, best)


def test_service_short_step_is_exact():
    """The kernel's steps 2..work: after step 1 x lies in [0, 1000], so
    y = fma(x, c, 0.5) lies in [0.5, 1000.501], where fmod(y, 1000) is
    y - 1000 for y >= 1000 (Sterbenz: exact) and y below, and JAX's sign
    fix-up never applies.  Checked on every float32 y in that range."""
    c = np.float32(so_ref.SERVICE_MUL)
    lo = np.float32(0.5)
    hi = _fma_f32(np.array([1000.0], np.float32), c, 0.5)[0]
    assert hi == np.float32(1000.50098)
    bits = np.arange(np.array(lo).view(np.int32),
                     np.array(hi).view(np.int32) + 1, dtype=np.int32)
    for chunk in np.array_split(bits, 12):
        y = chunk.view(np.float32)
        short = np.where(y >= np.float32(1000), y - np.float32(1000), y)
        np.testing.assert_array_equal(short, _jax_mod(y, 1000.0))
    # and every value step 1 leaves from a finite multiply-add lies in
    # [0, 1000]
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        rng.standard_normal(200000) * 10.0 ** rng.integers(-8, 30, 200000),
        [3e38, -3e38, -1000.5, -0.5, 1e-40]
    ]).astype(np.float32)
    x1 = _jax_mod(_fma_f32(keys, c, 0.5), 1000.0)
    assert float(x1.min()) >= 0.0 and float(x1.max()) <= 1000.0


def test_service_short_chain_equals_full_chain():
    """Whole 64-step chains: step 1 in full, then the short step, against
    the full step every time."""
    c = np.float32(so_ref.SERVICE_MUL)
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.random(20000, dtype=np.float32) * 2000 - 500,
                        rng.standard_normal(20000).astype(np.float32),
                        [0.0, -0.5, 999.5, -1000.5]]).astype(np.float32)
    full = _jax_mod(_fma_f32(x, c, 0.5), 1000.0)
    short = full.copy()
    for _ in range(63):
        full = _jax_mod(_fma_f32(full, c, 0.5), 1000.0)
        y = _fma_f32(short, c, 0.5)
        short = np.where(y >= np.float32(1000), y - np.float32(1000), y)
    np.testing.assert_array_equal(short, full)


def test_viete_halving_is_a_multiply():
    """a / 2 == a * 0.5 for every float32 a in [sqrt(2), 2], and Viète's
    chain stays there (it reaches 2.0 at its 12th step)."""
    lo, hi = np.float32(np.sqrt(np.float32(2))), np.float32(2)
    a = np.arange(np.array(lo).view(np.int32),
                  np.array(hi).view(np.int32) + 1,
                  dtype=np.int32).view(np.float32)
    np.testing.assert_array_equal(a / np.float32(2), a * np.float32(0.5))
    x = np.sqrt(np.float32(2))
    for _ in range(60):
        assert lo <= x <= hi
        x = np.sqrt(np.float32(2) + x)
