"""Parquet RLE / bit-packed hybrid index streams decoded on the device
(counterpart of nvme_strom_tpu/ops/bitunpack.py).

A dictionary index stream is a sequence of runs: RLE runs (a count and
one value) and bit-packed runs (``groups × 8`` values of ``bit_width``
bits, LSB first).  Only the run headers are sequential control flow, so
the host parses the headers alone (:func:`split_rle_hybrid`, a varint or
two per run) into a run table, ships the raw stream bytes and the table
to the device (two ``h2d_copy`` launches), and the device expands every
run of every page at once (:func:`_batch_decode`): each output row finds
its run with ``torch.searchsorted`` over the runs' output offsets, a
packed row reads its bits through a 4-byte little-endian gather window
(the value starts at stream bit ``bit_base + rel · bw``; a shift of at
most 7 plus a width of at most 24 fits the 32-bit window), and an RLE
row takes its run's literal.  The arithmetic is int64: torch's uint32
shifts are not dependable on CUDA.  No expanded index array exists on
the host.

:func:`_batch_decode` runs as a chain of torch operations, as the JAX
package's jitted program does (it reaches no Pallas kernel); its plain
version is the host decoder ``pq_direct.decode_rle_hybrid``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

#: give up on streams with more runs than this (the run table is 20
#: bytes a run; beyond it the host decode's bounce is the better trade)
MAX_SEGMENTS = 1 << 18

#: bit widths above this leave the device path: the 4-byte gather window
#: holds a shift of at most 7 plus at most 24 bits
MAX_BIT_WIDTH = 24

#: device decodes run (one per call of :func:`rle_hybrid_batch_to_device`
#: that reached the device)
DECODES = {"calls": 0, "runs": 0, "values": 0}


def split_rle_hybrid(buf, bit_width: int, count: int,
                     max_segments: int = MAX_SEGMENTS
                     ) -> Optional[List[Tuple]]:
    """Parse run headers only → segment list, or None when the device
    path should not be used (too many runs, or too wide a bit width).

    Segments: ``("rle", take, value)`` or ``("packed", start, nbytes,
    groups, take)``, ``take`` being the values the run contributes once
    the final run's padding is dropped."""
    if bit_width == 0:
        # a one-entry dictionary: every index is 0, no stream to parse
        return [("rle", count, 0)] if count else []
    if bit_width > MAX_BIT_WIDTH:
        return None
    if not isinstance(buf, (bytes, bytearray)):
        buf = memoryview(buf).cast("B")   # python ints, not numpy scalars
    byte_w = (bit_width + 7) // 8
    segs: List[Tuple] = []
    pos, filled, n = 0, 0, len(buf)
    while filled < count:
        if len(segs) >= max_segments:
            return None
        header = shift = 0
        while True:
            if pos >= n:
                raise ValueError("truncated RLE stream header")
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 35:
                raise ValueError("RLE header varint overflow")
        if header & 1:                       # bit-packed run
            groups = header >> 1
            nbytes = groups * bit_width
            if pos + nbytes > n:
                raise ValueError("truncated bit-packed run")
            take = min(groups * 8, count - filled)
            segs.append(("packed", pos, nbytes, groups, take))
            pos += nbytes
            filled += take
        else:                                # RLE run
            run = header >> 1
            if run == 0:
                raise ValueError("zero-length RLE run")
            if pos + byte_w > n:
                raise ValueError("truncated RLE run value")
            v = int.from_bytes(bytes(buf[pos:pos + byte_w]), "little")
            pos += byte_w
            take = min(run, count - filled)
            segs.append(("rle", take, v))
            filled += take
    return segs


def _batch_decode(u8: torch.Tensor, meta: torch.Tensor,
                  total: int) -> torch.Tensor:
    """Whole-stream decode on ``u8``'s device: (uint8 stream bytes with
    4 bytes of slack, (5, R) int64 run table) → int32 indices.

    Row ``i`` → run ``rid`` by ``searchsorted`` over the output offsets;
    a packed row bit-extracts through a 4-byte window; an RLE row takes
    its run's value."""
    out_start, bit_base, val, bw, kind = meta
    i = torch.arange(total, dtype=torch.int64, device=u8.device)
    rid = torch.searchsorted(out_start, i, right=True) - 1
    rel = i - out_start[rid]
    rbw = bw[rid]
    bb = bit_base[rid] + rel * rbw
    byte0 = torch.clamp(bb >> 3, max=u8.shape[0] - 4)
    b = u8.to(torch.int64)
    word = (b[byte0] | (b[byte0 + 1] << 8) | (b[byte0 + 2] << 16)
            | (b[byte0 + 3] << 24))
    pv = (word >> (bb & 7)) & ((1 << rbw) - 1)
    return torch.where(kind[rid] == 1, pv, val[rid]).to(torch.int32)


class RunTable:
    """The run table of a sequence of index streams, built stream by
    stream from their headers: :meth:`add` parses one stream and says
    whether its bytes must reach the device (it has bit-packed runs);
    :meth:`decode` expands every run on the device from the streams
    whose bytes were shipped, in order."""

    def __init__(self):
        self.rows: List[tuple] = []   # (out_start, bit_base, val, bw, kind)
        self.total = 0                # values
        self.payload = 0              # bytes of the streams shipped
        self.budget = MAX_SEGMENTS

    def add(self, buf, bit_width: int, count: int) -> Optional[bool]:
        """Parse ``buf``'s run headers → True when its bytes are needed
        on the device, False when not (RLE runs only), None when the
        device path declines the stream."""
        segs = split_rle_hybrid(buf, bit_width, count,
                                max_segments=self.budget)
        if segs is None:
            return None
        self.budget -= len(segs)
        need = any(s[0] == "packed" for s in segs)
        for s in segs:
            if s[0] == "rle":
                _, take, v = s
                self.rows.append((self.total, 0, v, 0, 0))
            else:
                _, start, nbytes, groups, take = s
                self.rows.append((self.total, (self.payload + start) * 8,
                                  0, bit_width, 1))
            self.total += take
        if need:
            self.payload += len(buf)
        return need

    def decode(self, u8_dev: Optional[torch.Tensor], dev: torch.device,
               engine=None) -> torch.Tensor:
        """int32 indices on ``dev``; ``u8_dev`` is the concatenation of
        the shipped streams (None when none was)."""
        from nvme_strom_tpu_torch.ops.bridge import to_device
        if self.total == 0:
            return torch.zeros((0,), dtype=torch.int32, device=dev)
        if u8_dev is None and len(self.rows) == 1:
            return torch.full((self.total,), self.rows[0][2],
                              dtype=torch.int32, device=dev)
        meta = np.ascontiguousarray(np.array(self.rows, np.int64).T)
        meta_dev = to_device(engine, meta, dev)
        slack = torch.zeros(4, dtype=torch.uint8, device=dev)
        u8 = slack if u8_dev is None else torch.cat([u8_dev, slack])
        DECODES["calls"] += 1
        DECODES["runs"] += len(self.rows)
        DECODES["values"] += self.total
        return _batch_decode(u8, meta_dev, self.total)


def rle_hybrid_batch_to_device(parts, dev: torch.device, engine=None
                               ) -> Optional[torch.Tensor]:
    """``[(buf, bit_width, count), ...]`` (page order, host buffers) →
    ONE int32 tensor on ``dev`` of the concatenated indices, or None when
    the caller must decode on the host.  Two copies to the device (the
    streams with bit-packed runs, the run table) and one decode, whatever
    the run count; a single RLE run is one ``full``."""
    from nvme_strom_tpu_torch.ops.bridge import to_device
    table = RunTable()
    shipped = []
    for buf, bit_width, count in parts:
        need = table.add(buf, bit_width, count)
        if need is None:
            return None
        if need:
            shipped.append(bytes(buf))
    u8 = (to_device(engine, np.frombuffer(b"".join(shipped), np.uint8),
                    dev) if shipped else None)
    return table.decode(u8, dev, engine)


def rle_hybrid_to_device(buf, bit_width: int, count: int, dev,
                         engine=None) -> Optional[torch.Tensor]:
    """Single-stream form of :func:`rle_hybrid_batch_to_device`."""
    return rle_hybrid_batch_to_device([(buf, bit_width, count)], dev,
                                      engine=engine)
