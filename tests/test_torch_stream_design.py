"""Models of the parse_xml and rolling_digest kernels' schedules, in numpy,
against the reference's jitted operators on JAX's CPU.

``kernels/stream_ops/csrc/stream_ops.cu`` cannot run here, so what its
designs change is rehearsed step by step on the same data:

* parse_xml's vector path: a row in 16-byte chunks, one a lane, the lanes
  a row from ``kernel.parse_xml_lanes``; each 32-bit word's bytes tested
  at once (the kernel's zero-byte bit tricks, ``__byte_perm``, ``__popc``,
  ``__dp4a``, emulated here on uint32 words), a chunk's last byte followed
  by the next
  lane's first byte (a shuffle), by the next pass's first chunk (a load)
  or, after the row's last chunk, by the row's byte 0; tags and checksum
  reduced over the lanes side by side;
* the digest: each lane of a tile of 16 adds its own in-tile prefix from
  0, lanes past the tile's last value stopping there; the levels of tile
  totals, in one block up to ``DIGEST_REACH`` tuples and level by level
  through device memory beyond; every output its prefix plus the scanned
  total of the tiles before it, one rounding.

Every output must equal the reference's, bytes 0-255 and parts past the
digest's former one-block ceiling of 184,320 tuples included.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.stream_ops import kernel as so_kernel
from repro_torch.kernels.stream_ops import ref as so_ref

U32 = np.uint32
#: the longest part the digest takes in one block: stream_ops.cu's
#: kDigestReach (1024 threads, 16 lanes a tile, up to 16 tiles a lane
#: group); the cuda test below holds the library to it
DIGEST_REACH = 16 * 1024


def jit_ref(name):
    """The reference's operator ``name`` jitted on JAX's CPU, taking and
    returning numpy batches."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import operators
    jitted = jax.jit(operators.OPERATORS[name])

    def run(batch):
        out = jitted({k: jnp.asarray(v) for k, v in batch.items()})
        return {k: np.asarray(v) for k, v in out.items()}
    return run


# -- parse_xml ---------------------------------------------------------------

def zero_bytes(x):
    """stream_ops.cu's zero_bytes: 0x80 in each byte of x that is zero,
    computed as the kernel does, on uint32 words."""
    return ~(((x & U32(0x7f7f7f7f)) + U32(0x7f7f7f7f)) | x) & U32(0x80808080)


def successors(w, nxt):
    """__byte_perm(w, nxt, 0x4321): w's bytes 1-3, then nxt's byte 0."""
    return (w >> U32(8)) | ((nxt & U32(0xff)) << U32(24))


def popc(x):
    return sum(((x >> U32(k)) & U32(1)).astype(np.int64) for k in range(32))


def open_tags(w, after):
    return popc(zero_bytes(w ^ U32(0x3c3c3c3c))
                & ~zero_bytes(after ^ U32(0x2f2f2f2f)))


def byte_sum(w):
    """__dp4a(w, 0x01010101, 0): the sum of w's four bytes, each times 1,
    unsigned."""
    return sum(((w >> U32(8 * k)) & U32(0xff)).astype(np.int64)
               for k in range(4))


def shfl_down(v, off):
    """__shfl_down_sync over a row's lanes (the last axis, the width):
    lane i takes lane i + off's value, or keeps its own past the end."""
    lanes = v.shape[-1]
    src = np.arange(lanes) + off
    return np.where(src < lanes, v[..., np.minimum(src, lanes - 1)], v)


def parse_xml_vector_model(payload):
    """(tags, checksum) of a (B, L) uint8 payload, L % 16 == 0, as the
    vector path computes them: the lanes' passes over the chunks, then the
    reduction over a row's lanes."""
    B, L = payload.shape
    lanes = so_kernel.parse_xml_lanes(0, L)
    chunks = L // 16
    words = np.ascontiguousarray(payload).view("<u4").reshape(B, chunks, 4)
    lane = np.arange(lanes)
    opened = np.zeros((B, lanes), np.int64)
    total = np.zeros((B, lanes), np.int64)
    first = None
    for base in range(0, chunks, lanes):
        c = base + lane
        mine = c < chunks
        w = np.where(mine[None, :, None],
                     words[:, np.minimum(c, chunks - 1)], U32(0))
        if base == 0:
            first = w[:, 0, 0]                       # lane 0's first word
        nxt = shfl_down(w[..., 0], 1)
        own = words[:, np.minimum(c + 1, chunks - 1), 0]   # the next pass's
        nxt = np.where(mine & (lane == lanes - 1) & (c + 1 < chunks), own, nxt)
        nxt = np.where(c == chunks - 1, first[:, None], nxt)
        after = [successors(w[..., k], w[..., k + 1]) for k in range(3)]
        after.append(successors(w[..., 3], nxt))
        # lanes with no chunk hold zeros, which count nothing
        opened += sum(open_tags(w[..., k], after[k]) for k in range(4))
        total += sum(byte_sum(w[..., k]) for k in range(4))
    off = lanes // 2
    while off:
        opened = opened + shfl_down(opened, off)
        total = total + shfl_down(total, off)
        off //= 2
    return opened[:, 0].astype(np.int32), total[:, 0].astype(np.int32)


def assert_parse_equal(payload):
    tags, checksum = parse_xml_vector_model(payload)
    want = jit_ref("parse_xml")({"payload": payload})
    np.testing.assert_array_equal(tags, want["tags"])
    np.testing.assert_array_equal(checksum, want["checksum"].astype(np.int64))
    port_tags, port_checksum = so_ref.parse_xml_reference(
        torch.from_numpy(payload))
    np.testing.assert_array_equal(tags, port_tags.numpy())
    np.testing.assert_array_equal(checksum, port_checksum.numpy())


@pytest.mark.parametrize("L", (16, 32, 256, 272, 4096))
def test_parse_xml_vector_model_equals_reference(L):
    """Every byte 0-255, with '<' and '/' common enough to meet."""
    rng = np.random.default_rng(L)
    payload = rng.integers(0, 256, size=(7, L), dtype=np.uint8)
    marks = rng.random(payload.shape)
    payload[marks < 0.1] = ord("<")
    payload[(marks >= 0.1) & (marks < 0.2)] = ord("/")
    payload[0] = 255                                 # the largest checksum
    assert_parse_equal(payload)


@pytest.mark.parametrize("L", (32, 256, 4096))
def test_parse_xml_vector_model_across_lanes(L):
    """'<' at every chunk's last byte, '/' at the next chunk's first byte in
    every other row: the successor crosses to the next lane, or at 4096
    (32 lanes, 8 passes) from lane 31 to the next pass's lane 0."""
    payload = np.full((4, L), ord("a"), dtype=np.uint8)
    payload[:, 15::16] = ord("<")
    payload[1::2, 16::16] = ord("/")
    tags, _ = parse_xml_vector_model(payload)
    assert tags.tolist() == [L // 16, 1, L // 16, 1]
    assert_parse_equal(payload)


@pytest.mark.parametrize("L", (16, 256, 4096))
def test_parse_xml_vector_model_wraps_the_row(L):
    """'<' at the row's last byte: its successor is the row's byte 0 (the
    reference's cyclic roll), '/' in the odd rows."""
    payload = np.full((4, L), 200, dtype=np.uint8)
    payload[:, -1] = ord("<")
    payload[1::2, 0] = ord("/")
    tags, checksum = parse_xml_vector_model(payload)
    assert tags.tolist() == [1, 0, 1, 0]
    assert checksum[0] == 200 * (L - 1) + ord("<")
    assert_parse_equal(payload)


@pytest.mark.parametrize("address, L, lanes", [
    (0, 256, 16), (4096, 16, 1), (64, 32, 2), (0, 272, 32), (0, 4096, 32),
    (1, 256, 0), (8, 256, 0), (0, 255, 0), (0, 1, 0),
])
def test_parse_xml_lanes_choose_the_path(address, L, lanes):
    """The vector path needs a 16-byte aligned payload and rows of a
    multiple of 16 bytes; a row of 256 bytes takes 16 lanes."""
    assert so_kernel.parse_xml_lanes(address, L) == lanes


def test_runtime_parts_take_the_vector_path():
    """The runtime's parts are row slices of a contiguous (n, 256) frame:
    each starts 16-byte aligned where the frame does; an odd byte offset
    takes the byte path."""
    frame = torch.zeros((64, 256), dtype=torch.uint8)
    assert frame.data_ptr() % 16 == 0
    for lo in (0, 1, 7, 16, 33):
        part = frame[lo:lo + 16]
        assert so_kernel.parse_xml_lanes(part.data_ptr(), 256) == 16
    buf = torch.zeros(16 * 256 + 1, dtype=torch.uint8)
    odd = buf[1:].view(16, 256)
    assert so_kernel.parse_xml_lanes(odd.data_ptr(), 256) == 0


# -- rolling_digest ------------------------------------------------------------

def lane_prefixes(level):
    """Each lane's own in-tile prefix over a level's tiles of 16 (zeros past
    its end): lane i adds v_0 .. v_i from 0, in order, in float32; lanes
    past a tile's last value stop there.  Returns (prefixes of the level's
    n values, the tiles' totals: their lane 15's prefix)."""
    n = level.shape[0]
    tiles = -(-n // 16)
    v = np.zeros(tiles * 16, np.float32)
    v[:n] = level
    v = v.reshape(tiles, 16)
    last = np.minimum(n - 16 * np.arange(tiles), 16) - 1
    stop = np.minimum(np.arange(16)[None, :], last[:, None])
    acc = np.zeros((tiles, 16), np.float32)
    for k in range(16):
        acc = np.where(k <= stop, acc + v[:, k:k + 1], acc)
    return acc.reshape(-1)[:n], acc[:, 15].copy()


def add_offsets(prefixes, scanned):
    """prefix + the scanned total of the tiles before its tile (0 for the
    first), one float32 rounding each."""
    offsets = np.concatenate([np.zeros(1, np.float32), scanned[:-1]])
    return prefixes + np.repeat(offsets, 16)[:prefixes.shape[0]]


def block_scan(level):
    """digest_block_kernel's running sum of a level of at most
    DIGEST_REACH values: its tile totals level by level (shared memory),
    the top level (<= 16 values) scanned alone, no offset."""
    if level.shape[0] <= 16:
        return lane_prefixes(level)[0]
    prefixes, totals = lane_prefixes(level)
    return add_offsets(prefixes, block_scan(totals))


def digest_model(x):
    """(digest, kernels launched, scratch floats) of a (B,) float32 or
    int32 column, as the C entry point schedules it."""
    level = x.astype(np.float32)
    kernels, scratch, below = [], 0, []
    while level.shape[0] > DIGEST_REACH:              # digest_tiles_kernel
        prefixes, level = lane_prefixes(level)
        below.append(prefixes)
        kernels.append("tiles")
        scratch += level.shape[0]
    scanned = block_scan(level)
    kernels.append("block")
    while below:                                      # digest_offsets_kernel
        scanned = add_offsets(below.pop(), scanned)
        kernels.append("offsets")
    r = np.fmod(scanned, np.float32(65521.0))
    digest = np.where(r < 0, r + np.float32(65521.0), r).astype(np.float32)
    return digest, kernels, scratch


@pytest.mark.parametrize("B", (1, 15, 16, 17, 256, 257, 1024, 4097, 65537,
                               200_000))
def test_digest_schedule_model_equals_reference(B):
    """Values in [0, 1), wide signed values and checksums of bytes 0-255,
    bit for bit against ``jnp.cumsum(v) % 65521``; the launches and the
    scratch the wrapper allocates as the C entry point needs them."""
    rng = np.random.default_rng(B)
    ref = jit_ref("batch_file_write")
    checksum = rng.integers(0, 256, size=(B, 256), dtype=np.uint8).sum(
        axis=1, dtype=np.uint32)
    value = rng.random(B, dtype=np.float32)
    signed = (rng.standard_normal(B) * 1e3).astype(np.float32)
    for batch, column in (({"value": value}, value),
                          ({"value": signed}, signed),
                          ({"checksum": checksum}, checksum.astype(np.int32))):
        got, kernels, scratch = digest_model(column)
        want = ref(batch)["digest"]
        np.testing.assert_array_equal(got, want)
        port = so_ref.rolling_digest_reference(torch.from_numpy(column))
        np.testing.assert_array_equal(got.view(np.int32),
                                      port.numpy().view(np.int32))
    past = B > DIGEST_REACH
    assert kernels == (["tiles", "block", "offsets"] if past else ["block"])
    assert scratch == (-(-B // 16) if past else 0)


def test_digest_scratch_grows_a_level_at_a_time():
    """Two levels past one block's reach: 16 x 16384 tuples is the first
    part whose tile totals no longer fit one block either."""
    reach = DIGEST_REACH
    for B, want in ((reach, 0), (reach + 1, reach // 16 + 1),
                    (16 * reach, reach)):
        assert digest_model(np.zeros(B, np.float32))[2] == want
    B = 16 * reach + 1
    x = np.arange(B, dtype=np.int32) % 7
    got, kernels, scratch = digest_model(x)
    assert kernels == ["tiles", "tiles", "block", "offsets", "offsets"]
    assert scratch == reach + 1 + (reach // 16 + 1)
    want = so_ref.rolling_digest_reference(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
def test_cuda_digest_scratch_matches_model():
    """The library's reach and scratch sizes (stream_ops.cu lays out the
    levels) are the model's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")
    assert so_kernel.digest_reach() == DIGEST_REACH
    for B in (1, DIGEST_REACH, DIGEST_REACH + 1, 200_000, 16 * DIGEST_REACH,
              16 * DIGEST_REACH + 1):
        want = digest_model(np.zeros(B, np.float32))[2]
        assert so_kernel.digest_scratch_floats(B) == want
