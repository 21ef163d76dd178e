"""The port's RLE / bit-packed hybrid decode (nvme_strom_tpu_torch/ops/
bitunpack.py) held against the JAX package's ``split_rle_hybrid`` and
``rle_hybrid_batch_to_device`` and against the host decoder
``decode_rle_hybrid`` (its plain version), on the CPU: every bit width
from 0 to 24, RLE and bit-packed runs, padding in the final run, pages
batched into one decode, the declines (bit width > 24, too many runs) and
the malformed streams of tests/test_bitunpack.py."""

import numpy as np
import pytest
import torch

import jax

from nvme_strom_tpu.ops import bitunpack as jbu
from nvme_strom_tpu.sql.pq_direct import decode_rle_hybrid as jax_decode
from nvme_strom_tpu_torch.ops import bitunpack as bu
from nvme_strom_tpu_torch.sql.pq_direct import decode_rle_hybrid
from nvme_strom_tpu_torch.sql.pqwrite import encode_bitpacked


def _varint(n):
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _stream(rng, bw, n_runs=6):
    """A hybrid stream of alternating RLE and bit-packed runs → (bytes,
    count); the final packed run carries padding past the count."""
    parts, count = [], 0
    byte_w = (bw + 7) // 8
    for i in range(n_runs):
        if i % 2 == 0:
            run = int(rng.integers(1, 40))
            v = int(rng.integers(0, 1 << bw)) if bw else 0
            parts.append(_varint(run << 1) + v.to_bytes(byte_w, "little"))
            count += run
        else:
            n = int(rng.integers(1, 60))
            vals = rng.integers(0, 1 << bw, n) if bw else np.zeros(n)
            parts.append(encode_bitpacked(vals, bw))
            count += n
    return b"".join(parts), count


@pytest.mark.parametrize("bw", list(range(0, 25)))
def test_device_decode_matches_host_and_jax(bw):
    rng = np.random.default_rng(bw)
    buf, count = _stream(rng, max(bw, 1) if bw else 1)
    if bw == 0:
        buf, count = b"", 37
    host = decode_rle_hybrid(buf, bw, count)
    assert np.array_equal(host, jax_decode(buf, bw, count))
    assert bu.split_rle_hybrid(buf, bw, count) == \
        jbu.split_rle_hybrid(buf, bw, count)
    dev = bu.rle_hybrid_to_device(buf, bw, count, torch.device("cpu"))
    assert dev.dtype == torch.int32
    assert np.array_equal(dev.numpy(), host)
    jdev = jbu.rle_hybrid_to_device(buf, bw, count, jax.devices("cpu")[0])
    assert np.array_equal(np.asarray(jdev), host)


def test_batched_pages_match_jax():
    rng = np.random.default_rng(11)
    parts = []
    for bw in (1, 3, 5, 9, 17, 24, 0, 2):
        buf, count = _stream(rng, bw) if bw else (b"", 13)
        parts.append((buf, bw, count))
    want = np.concatenate([decode_rle_hybrid(*p) for p in parts])
    got = bu.rle_hybrid_batch_to_device(parts, torch.device("cpu"))
    assert np.array_equal(got.numpy(), want)
    jgot = jbu.rle_hybrid_batch_to_device(parts, jax.devices("cpu")[0])
    assert np.array_equal(np.asarray(jgot), want)
    table = bu.RunTable()
    for buf, bw, count in parts:
        assert table.add(buf, bw, count) is not None
    assert table.total == len(want)


def test_run_edges_and_declines():
    cpu = torch.device("cpu")
    # one RLE run: a full, no stream shipped
    buf = _varint(40 << 1) + b"\x07"
    assert bu.rle_hybrid_to_device(buf, 3, 40, cpu).tolist() == [7] * 40
    # a run cut short by the count (the final run's padding dropped)
    vals = np.arange(16) % 8
    buf = encode_bitpacked(vals, 3)
    assert bu.rle_hybrid_to_device(buf, 3, 11, cpu).tolist() == \
        vals[:11].tolist()
    # bit width 25 or too many runs: the caller decodes on the host
    assert bu.rle_hybrid_to_device(encode_bitpacked(vals, 25), 25, 16,
                                   cpu) is None
    many = b"".join(_varint(1 << 1) + b"\x01" for _ in range(10))
    assert bu.split_rle_hybrid(many, 1, 10, max_segments=4) is None
    assert bu.rle_hybrid_to_device(b"", 3, 0, cpu).shape == (0,)


@pytest.mark.parametrize("buf,bw,count,msg", [
    (b"", 3, 5, "truncated RLE stream header"),
    (b"\x03", 3, 8, "truncated bit-packed run"),
    (b"\x00\x01", 3, 5, "zero-length RLE run"),
    (b"\x0a", 9, 5, "truncated RLE run value"),
    (b"\xff\xff\xff\xff\xff\xff", 3, 5, "varint overflow"),
])
def test_malformed_streams_raise_like_jax(buf, bw, count, msg):
    with pytest.raises(ValueError, match=msg):
        bu.split_rle_hybrid(buf, bw, count)
    with pytest.raises(ValueError, match=msg):
        jbu.split_rle_hybrid(buf, bw, count)
    with pytest.raises(ValueError, match=msg):
        decode_rle_hybrid(buf, bw, count)
