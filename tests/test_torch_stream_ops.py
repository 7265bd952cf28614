"""The port's stream-operator bodies (``kernels/stream_ops``, called by
``runtime/operators.py``) against the reference's ``OPERATORS`` jitted on
JAX's CPU.

Both packages run the same seeded parts: (B, L) uint8 payloads drawn as
``SyntheticSource`` draws them and (B,) float32 values, at ragged part
sizes (B = 1, 7, 16, 33).  Every output must be equal, float32 ones
included: the plain versions round as XLA's CPU programs do (one rounding
for the service's multiply-add, XLA's order of sums and of the digest's
scan, JAX's ``%``; ``tests/test_torch_stream_exact.py`` holds each of
these over more parts and signs).  On the CPU the port runs each kernel's
plain PyTorch version; the ``cuda`` tests hold the kernels against those
plain versions on the card, to 0, and an executor on the card against one
on the CPU.  The GPU machine has no JAX, so the reference is imported
inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.stream_ops import kernel as so_kernel
from repro_torch.kernels.stream_ops import ops as so_ops
from repro_torch.kernels.stream_ops import ref as so_ref
from repro_torch.runtime import operators as port_operators

PARTS = (1, 7, 16, 33)
KINDS = ("parse_xml", "pi", "batch_file_write", "azure_blob", "azure_table",
         "source", "sink")


def draw(B, L=256, seed=0):
    """A part as SyntheticSource draws it: payload bytes in [32, 127) and
    values in [0, 1)."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(32, 127, size=(B, L), dtype=np.uint8)
    value = rng.random(B, dtype=np.float32)
    return {"payload": payload, "value": value}


def ref_ops():
    from repro.runtime import operators
    return operators


def jit_ref(fn):
    import jax
    return jax.jit(fn)


def jnp_array(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def run_ref(kind, part):
    fn = jit_ref(ref_ops().OPERATORS[kind])
    out = fn({k: jnp_array(v) for k, v in part.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(kind, part):
    op = port_operators.make_operator(kind, "cpu")
    out = op({k: torch.from_numpy(np.array(v)) for k, v in part.items()})
    return {k: v.numpy() for k, v in out.items()}


def assert_same(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        if np.issubdtype(ref[k].dtype, np.floating):
            assert port[k].dtype == np.float32, k
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            np.testing.assert_array_equal(port[k].astype(np.int64),
                                          ref[k].astype(np.int64), err_msg=k)


@pytest.mark.parametrize("B", PARTS)
@pytest.mark.parametrize("kind", KINDS)
def test_operator_matches_reference(kind, B):
    part = draw(B, seed=B)
    assert_same(run_port(kind, part), run_ref(kind, part))


@pytest.mark.parametrize("B", PARTS)
def test_digest_of_parsed_checksums_is_exact(B):
    """batch_file_write after parse_xml digests the integer checksum: the
    running sums are integers below 2**24, so exact in float32."""
    part = run_ref("parse_xml", draw(B, seed=100 + B))
    ref = run_ref("batch_file_write", part)
    port = run_port("batch_file_write", part)
    np.testing.assert_array_equal(port["digest"], ref["digest"])
    assert_same(port, ref)


@pytest.mark.parametrize("L", (1, 2, 31, 37, 256))
def test_parse_xml_ragged_rows(L):
    part = draw(9, L=L, seed=L)
    assert_same(run_port("parse_xml", part), run_ref("parse_xml", part))


@pytest.mark.parametrize("first, last, expect", [
    (ord("/"), ord("<"), 0),     # the last '<' is closed by byte 0's '/'
    (ord("a"), ord("<"), 1),     # the last '<' opens a tag
    (ord("<"), ord("/"), 1),     # byte 0's '<' is not followed by the '/'
])
def test_parse_xml_roll_is_cyclic(first, last, expect):
    payload = np.full((3, 16), ord("x"), dtype=np.uint8)
    payload[:, 0], payload[:, -1] = first, last
    part = {"payload": payload, "value": np.zeros(3, np.float32)}
    port, ref = run_port("parse_xml", part), run_ref("parse_xml", part)
    assert_same(port, ref)
    assert port["tags"].tolist() == [expect] * 3


def test_parse_xml_counts_tags_of_markup():
    text = b"<r><a>1</a><b>2</b></r>" * 4
    payload = np.frombuffer(text, dtype=np.uint8)[None, :].repeat(2, axis=0)
    part = {"payload": payload, "value": np.ones(2, np.float32)}
    port, ref = run_port("parse_xml", part), run_ref("parse_xml", part)
    assert_same(port, ref)
    assert port["tags"].tolist() == [12, 12]
    assert port["checksum"].tolist() == [sum(text)] * 2


@pytest.mark.parametrize("with_checksum", (False, True))
@pytest.mark.parametrize("B", (1, 16, 33))
def test_batch_file_write_column(with_checksum, B):
    """The digest runs over ``checksum`` where a parse came first, else over
    ``value``."""
    part = draw(B, seed=7 * B)
    if with_checksum:
        part["checksum"] = part["payload"].astype(np.uint32).sum(axis=1)
    assert_same(run_port("batch_file_write", part),
                run_ref("batch_file_write", part))


def test_pi_is_vietes_product():
    got = so_ref.viete_pi_reference(4, torch.device("cpu"))
    assert got.dtype == torch.float32
    assert torch.allclose(got, torch.full((4,), np.pi, dtype=torch.float32),
                          rtol=1e-6)


@pytest.mark.parametrize("iterations", (1, 2, 15, 30))
def test_pi_iterations_match_reference(iterations):
    fn = jit_ref(lambda b: ref_ops()._op_pi(b, iterations=iterations))
    ref = np.asarray(fn({"value": jnp_array(np.zeros(5, np.float32))})["pi"])
    got = so_ops.viete_pi(torch.zeros(5), iterations).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("work", (0, 1, 64, 200))
def test_service_chain_matches_reference(work):
    v = draw(16, seed=work)["value"]
    fn = jit_ref(lambda b: ref_ops()._op_external_service(b, work=work))
    ref = np.asarray(fn({"value": jnp_array(v)})["service"])
    got = so_ops.external_service(torch.from_numpy(v), work).numpy()
    np.testing.assert_array_equal(got, ref)


def test_service_chain_wraps_at_the_modulus():
    """A key near 1000 crosses the modulus: fmod, not a floor formula."""
    v = np.full(4, 249.9, dtype=np.float32)
    fn = jit_ref(ref_ops()._op_external_service)
    ref = np.asarray(fn({"value": jnp_array(v)})["service"])
    got = so_ops.external_service(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] < 100.0


def test_tables_match_reference():
    assert set(port_operators.OPERATORS) == set(ref_ops().OPERATORS)
    assert port_operators.SERVICE_LATENCY == ref_ops().SERVICE_LATENCY
    assert set(port_operators.KERNEL_OF) == set(KINDS) - {"source", "sink"}
    assert set(port_operators.KERNEL_OF.values()) == set(so_kernel.KERNELS)


def test_identity_operators_keep_their_tensors():
    part = {k: torch.from_numpy(v) for k, v in draw(4).items()}
    for kind in ("source", "sink"):
        out = port_operators.make_operator(kind, "cpu")(part)
        assert all(out[k] is part[k] for k in part)


@pytest.mark.parametrize("call", [
    lambda: so_kernel.parse_xml_fwd(torch.zeros((2, 8), dtype=torch.uint8)),
    lambda: so_kernel.viete_pi_fwd(torch.zeros(2)),
    lambda: so_kernel.rolling_digest_fwd(torch.zeros(2)),
    lambda: so_kernel.external_service_fwd(torch.zeros(2)),
], ids=so_kernel.KERNELS)
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers never run the plain version: a CPU tensor raises
    (the dispatch in ``ops`` sends it to ``ref`` instead), and nothing is
    built or counted."""
    so_kernel.reset_launch_count()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert so_kernel.launch_count() == dict.fromkeys(so_kernel.KERNELS, 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")
    dev = torch.device("cuda")
    so_kernel.reset_launch_count()
    for B in PARTS + (32, 1024, -5, -16):
        part = draw(abs(B), seed=abs(B))
        payload = torch.from_numpy(part["payload"]).to(dev)
        value = torch.from_numpy(part["value"]).to(dev)
        if B == -5:                     # a negative part
            value = value * 1000.0 - 700.0
        if B == -16:                    # a service key whose chain wraps
            value = torch.full_like(value, 61.0)
        tags, checksum = so_kernel.parse_xml_fwd(payload)
        ref_tags, ref_checksum = so_ref.parse_xml_reference(payload)
        assert torch.equal(tags, ref_tags) and torch.equal(checksum,
                                                           ref_checksum)
        for x in (value, checksum, -checksum):
            got = so_kernel.rolling_digest_fwd(x)
            want = so_ref.rolling_digest_reference(x)
            assert torch.equal(got, want)
        assert torch.equal(so_kernel.viete_pi_fwd(value),
                           so_ref.viete_pi_reference(abs(B), dev))
        assert torch.equal(so_kernel.external_service_fwd(value),
                           so_ref.external_service_reference(value))
    rng = np.random.default_rng(0)          # past one block's reach
    long_part = torch.from_numpy(rng.random(200_000, dtype=np.float32)).to(dev)
    assert torch.equal(so_kernel.rolling_digest_fwd(long_part),
                       so_ref.rolling_digest_reference(long_part))
    torch.cuda.synchronize()
    n = len(PARTS) + 4
    assert so_kernel.launch_count() == {
        "parse_xml": n, "viete_pi": n, "rolling_digest": 3 * n + 1,
        "external_service": n}
    # the parts are contiguous (B, 256) payloads: 16-byte aligned rows
    assert so_kernel.parse_xml_path_count() == {"vector": n, "byte": 0}


@pytest.mark.cuda
def test_cuda_executor_matches_cpu():
    """The same seeded windows of a planned DAG through executors on the
    card and on the CPU (virtual time): equal reports, and one kernel
    launch per operator call of the four kinds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")
    import repro_torch.core as core
    import repro_torch.runtime as rt

    lib = core.paper_library()
    for dag in ("linear", "diamond", "star"):
        sched = core.plan(core.ALL_DAGS[dag](), 80.0, lib, allocator="mba",
                          mapper="sam")
        reports = {}
        for device in ("cuda", "cpu"):
            ex = rt.StreamExecutor(sched, lib, clock=rt.VirtualClock(),
                                   device=device)
            so_kernel.reset_launch_count()
            reports[device] = ex.run(80.0, n_frames=8, batch=16)
            launches = so_kernel.launch_count()
            if device == "cuda":
                want = dict.fromkeys(so_kernel.KERNELS, 0)
                for kind, n in ex.invocations.items():
                    if kind in port_operators.KERNEL_OF:
                        want[port_operators.KERNEL_OF[kind]] += n
                assert launches == want
            else:
                assert sum(launches.values()) == 0
        a, b = reports["cuda"], reports["cpu"]
        assert (a.throughput, a.mean_latency, a.frames, a.tuples) == \
            (b.throughput, b.mean_latency, b.frames, b.tuples)
        assert sorted(a.device_frame_counts.values()) == \
            sorted(b.device_frame_counts.values())
