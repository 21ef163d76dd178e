"""Parquet page codecs the port decodes itself: GZIP through ``zlib`` and
SNAPPY through a decoder of its own.  ZSTD, BROTLI, LZ4 and LZ4_RAW need
a codec library that the port does not carry: their chunks are refused
with the reason ``"compression <NAME>"``.

Decompression is host work on the page bytes (sequential bitstream
control flow), so the decompressed bytes are counted as bounce wherever
they travel on to the device."""

from __future__ import annotations

import zlib

AVAILABLE = ("GZIP", "SNAPPY")


def available(name: str) -> bool:
    return name in AVAILABLE


def snappy_decompress(buf) -> bytes:
    """Raw (unframed) Snappy: a varint of the uncompressed length, then
    elements whose tag byte's low two bits pick a literal (00) or a copy
    with a 1-, 2- or 4-byte offset (01, 10, 11).  A copy may overlap its
    own output (offset < length): it repeats the pattern."""
    src = memoryview(buf).cast("B")
    n = len(src)
    pos = shift = ulen = 0
    while True:
        if pos >= n:
            raise ValueError("snappy: truncated length")
        b = src[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 35:
            raise ValueError("snappy: length varint overflow")
    out = bytearray()
    while pos < n:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                if pos + extra > n:
                    raise ValueError("snappy: truncated literal length")
                ln = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            ln += 1
            if pos + ln > n:
                raise ValueError("snappy: truncated literal")
            out += src[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            if pos >= n:
                raise ValueError("snappy: truncated copy")
            ln = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | src[pos]
            pos += 1
        else:
            w = 2 if kind == 2 else 4
            if pos + w > n:
                raise ValueError("snappy: truncated copy")
            ln = (tag >> 2) + 1
            off = int.from_bytes(src[pos:pos + w], "little")
            pos += w
        start = len(out) - off
        if off == 0 or start < 0:
            raise ValueError(f"snappy: copy offset {off} outside output")
        if off >= ln:
            out += out[start:start + ln]
        else:
            pat = bytes(out[start:])
            reps, rest = divmod(ln, off)
            out += pat * reps + pat[:rest]
    if len(out) != ulen:
        raise ValueError(f"snappy: decoded {len(out)} bytes, header says "
                         f"{ulen}")
    return bytes(out)


def decompress(codec: str, buf, out_len: int) -> bytes:
    """One page body decompressed; raises when the result is not
    ``out_len`` bytes (the page header's uncompressed size)."""
    if codec == "GZIP":
        d = zlib.decompressobj(wbits=47)     # gzip or zlib header
        out = d.decompress(buf)
        out += d.flush()
    elif codec == "SNAPPY":
        out = snappy_decompress(buf)
    else:
        raise NotImplementedError(
            f"compression {codec}: the port decodes only "
            f"{', '.join(AVAILABLE)}")
    if len(out) != out_len:
        raise ValueError(f"codec {codec}: decompressed {len(out)} bytes, "
                         f"header promised {out_len}")
    return out


def compress_gzip(buf, level: int = 6) -> bytes:
    """GZIP for the writer (``wbits=31``: the gzip container)."""
    c = zlib.compressobj(level, zlib.DEFLATED, 31)
    return c.compress(buf) + c.flush()
