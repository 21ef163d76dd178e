"""Direct Parquet column decode: NVMe pages → device, no pyarrow
(counterpart of nvme_strom_tpu/sql/pq_direct.py).

The host plans, the device decodes.  The footer (sql/pqmeta.py) and each
page header (a Thrift compact struct of ~40 bytes) give the exact byte
spans of every page's values; the spans ride the O_DIRECT engine into
its staging buffers and ``DeviceStream.stream_ranges`` copies them to
the device with ``h2d_copy`` (kernel 1).  The decode happens there:

- **PLAIN** pages: the value bytes are the values.  The decode is a
  ``view`` of the bytes as the physical type (int32, int64, float32,
  float64; 8-byte types are read bitwise, where the JAX package refuses
  them without x64).  A column chunk whose page headers are a small
  fraction of its bytes streams as its enclosing range and the headers
  are cut out on the device (``_degap``).
- **Dictionary** chunks: the dictionary page's PLAIN values stream the
  same way; the data pages' RLE / bit-packed index streams are read
  through the engine, their run headers parsed on the host and the runs
  expanded on the device (ops/bitunpack.py); the decode is an index
  into the dictionary, after a range check (torch raises where
  ``jnp.take`` clamps).  Chunks whose writer fell back to PLAIN mid-chunk
  assemble both kinds in page order.
- **BYTE_STREAM_SPLIT** pages: a reshape and transpose of the page bytes
  on the device before the view.
- **Compressed** chunks (GZIP, SNAPPY; sql/codecs.py): the compressed
  page bytes ride the engine like any span, the host decompresses them
  straight from the staging buffer, and the decompressed bytes (counted
  as bounce) go on to the device for the same decode.  ZSTD, BROTLI,
  LZ4 and LZ4_RAW are refused with the reason ``"compression <NAME>"``.
- **Nulls** (``nulls="mask"``): definition levels decode on the host into
  a per-page validity mask; the dense values take their normal path and
  a cumsum-gather on the device spreads them to the page's length, null
  slots zero.  Consumers get ``(values, mask)`` pairs.

Anything else (nested or repeated fields, DELTA encodings, codecs the
port lacks, strings outside the dictionary-code scan) is not direct:
``ParquetScanner``'s host path decodes what it can and raises
``NotImplementedError`` naming the column and the reason for the rest.

Byte accounting, as in ops/bridge.py: payload that reaches the device
from registered staging memory is direct; bytes the host must touch
(index streams, level blocks, decompressed pages) are bounce.
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nvme_strom_tpu_torch.sql import codecs
from nvme_strom_tpu_torch.sql.pqmeta import (CT_BOOL_FALSE, CT_BOOL_TRUE,
                                             CT_I32, CT_STRUCT, Compact,
                                             ThriftError)

#: the QoS latency class every sql/ payload read rides (io/sched.py)
SCAN_CLASS = "scan"

# Parquet physical types that are raw fixed-width little-endian under PLAIN
_WIDTHS = {"INT32": 4, "INT64": 8, "FLOAT": 4, "DOUBLE": 8}
_NP_DTYPES = {"INT32": "<i4", "INT64": "<i8", "FLOAT": "<f4",
              "DOUBLE": "<f8"}
_TORCH_DTYPES = {"INT32": torch.int32, "INT64": torch.int64,
                 "FLOAT": torch.float32, "DOUBLE": torch.float64}

# parquet-format enums
_PAGE_DATA = 0
_PAGE_DICTIONARY = 2
_PAGE_DATA_V2 = 3
_ENC_PLAIN = 0
_ENC_PLAIN_DICTIONARY = 2
_ENC_RLE = 3
_ENC_RLE_DICTIONARY = 8
_ENC_BYTE_STREAM_SPLIT = 9
_DICT_ENCODINGS = (_ENC_PLAIN_DICTIONARY, _ENC_RLE_DICTIONARY)

__all__ = ["ThriftError", "PageHeader", "parse_page_header", "PagePart",
           "ColumnPlan", "eligible_chunk", "plan_chunk", "plan_columns",
           "decode_rle_hybrid", "read_plain_columns_to_device",
           "iter_plain_row_groups_to_device", "read_dict_key_column",
           "try_plan"]


@dataclass(frozen=True)
class PageHeader:
    type: int
    compressed_size: int
    uncompressed_size: int
    num_values: int          # data/dictionary pages (0 otherwise)
    encoding: int            # data/dictionary pages (-1 otherwise)
    header_len: int          # bytes the Thrift header itself occupies
    # DataPageHeaderV2 states the level-block lengths explicitly
    def_levels_len: int = 0
    rep_levels_len: int = 0
    # DataPageHeaderV2 field 7: false = the values region is stored raw
    # even though the chunk declares a codec
    v2_is_compressed: bool = True


def parse_page_header(buf: bytes) -> PageHeader:
    """Parse a PageHeader at buf[0].  Raises ThriftError if ``buf`` is too
    short (callers re-read with a larger window)."""
    c = Compact(buf)
    ptype = comp = uncomp = -1
    num_values, encoding = 0, -1
    def_len = rep_len = 0
    v2_compressed = True
    last = 0
    while True:
        t, fid = c.read_field_header(last)
        if t == 0:
            break
        last = fid
        if fid == 1 and t == CT_I32:
            ptype = c.zigzag()
        elif fid == 2 and t == CT_I32:
            uncomp = c.zigzag()
        elif fid == 3 and t == CT_I32:
            comp = c.zigzag()
        elif fid in (5, 7, 8) and t == CT_STRUCT:
            # DataPageHeader (v1) / DictionaryPageHeader / DataPageHeaderV2
            inner_last = 0
            while True:
                it, ifid = c.read_field_header(inner_last)
                if it == 0:
                    break
                inner_last = ifid
                if ifid == 1 and it == CT_I32:
                    num_values = c.zigzag()
                elif ifid == 2 and it == CT_I32 and fid in (5, 7):
                    encoding = c.zigzag()
                elif ifid == 4 and it == CT_I32 and fid == 8:
                    encoding = c.zigzag()
                elif ifid == 5 and it == CT_I32 and fid == 8:
                    def_len = c.zigzag()
                elif ifid == 6 and it == CT_I32 and fid == 8:
                    rep_len = c.zigzag()
                elif (ifid == 7 and fid == 8
                      and it in (CT_BOOL_TRUE, CT_BOOL_FALSE)):
                    # bool struct fields carry the value in the type nibble
                    v2_compressed = it == CT_BOOL_TRUE
                else:
                    c.skip(it)
        else:
            c.skip(t)
    if ptype < 0 or comp < 0:
        raise ThriftError("missing required PageHeader fields")
    return PageHeader(ptype, comp, uncomp, num_values, encoding, c.pos,
                      def_len, rep_len, v2_compressed)


@dataclass(frozen=True)
class PagePart:
    """One data page's decodable payload within a column chunk.

    kind "plain": ``span`` covers raw little-endian values.  kind "dict":
    ``span`` covers the RLE / bit-packed index stream; ``bit_width`` is
    its width.  kind "bss": BYTE_STREAM_SPLIT values.  ``codec`` set:
    ``span`` covers compressed bytes; a compressed v1 page with
    definition levels sets ``inline_levels`` (its levels parse from the
    decompressed body).  ``mask`` (True = present) is None when every
    value is present."""
    kind: str                              # "plain" | "dict" | "bss"
    span: Tuple[int, int]                  # (offset, length) into the file
    num_values: int                        # values INCLUDING nulls
    bit_width: int = 0                     # dict parts (-1 = in codec body)
    codec: Optional[str] = None            # Parquet codec name
    uncompressed_len: int = 0              # decompressed span length
    inline_levels: bool = False            # v1+codec: levels in the body
    max_def: int = 0                       # schema max definition level
    n_valid: int = -1                      # -1 = num_values (no nulls)
    mask: Optional[object] = None          # np.bool_ mask, plan-time known

    @property
    def valid_count(self) -> int:
        return self.num_values if self.n_valid < 0 else self.n_valid

    @property
    def is_raw(self) -> bool:
        """Payload can ride staging→device untouched (no host decode)."""
        return self.codec is None and self.mask is None


@dataclass(frozen=True)
class ColumnPlan:
    """Decodable page layout of one column chunk (one row group)."""
    parts: Tuple[PagePart, ...]            # in file/page order
    num_values: int
    physical_type: str
    dict_span: Optional[Tuple[int, int]] = None   # PLAIN dictionary values
    dict_count: int = 0
    dict_codec: Optional[str] = None       # dictionary page's codec
    dict_uncompressed_len: int = 0

    @property
    def spans(self) -> Tuple[Tuple[int, int], ...]:
        """Plain value-byte spans."""
        return tuple(p.span for p in self.parts if p.kind == "plain")


def _codec_of(col) -> Optional[str]:
    """Column chunk's codec name, None when uncompressed."""
    name = col.compression or "UNCOMPRESSED"
    return None if name == "UNCOMPRESSED" else name


def _codec_available(name: str) -> bool:
    return codecs.available(name)


def _decompress(codec: str, buf, out_len: int) -> bytes:
    return codecs.decompress(codec, buf, out_len)


def eligible_chunk(meta, rg: int, ci: int,
                   allow_nulls: bool = False) -> Optional[str]:
    """None if the (row group, column) chunk can decode on the device,
    else the reason it cannot.

    ``allow_nulls``: chunks with (possible) nulls are eligible; the caller
    consumes (values, mask) pairs."""
    col = meta.row_group(rg).column(ci)
    sc = meta.schema.column(ci)
    if col.physical_type not in _WIDTHS:
        return f"physical type {col.physical_type}"
    codec = _codec_of(col)
    if codec is not None and not _codec_available(codec):
        return f"compression {col.compression}"
    encs = set(col.encodings)
    if not encs <= {"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY",
                    "BYTE_STREAM_SPLIT"}:
        return f"encodings {sorted(encs)}"
    if sc.max_repetition_level != 0:
        return "repeated field"
    if sc.max_definition_level > 0 and not allow_nulls:
        st = col.statistics
        if st is None or st.null_count is None:
            return "no null statistics"
        if st.null_count != 0:
            return f"{st.null_count} nulls (pass nulls='mask')"
    return None


def _walk_pages(col, raw_read):
    """Yield (pos, PageHeader) for every page of a column chunk, until
    the data pages' value counts cover ``col.num_values``.
    ``raw_read(offset, length) -> bytes`` serves page headers."""
    pos = col.data_page_offset
    if (col.dictionary_page_offset or 0) > 0:
        pos = min(pos, col.dictionary_page_offset)
    end = pos + col.total_compressed_size
    remaining = col.num_values
    window = 1 << 10
    while remaining > 0:
        if pos >= end:
            raise ValueError(f"page walk ran past chunk end at {pos}")
        buf = raw_read(pos, min(window, end - pos))
        while True:
            try:
                ph = parse_page_header(buf)
                break
            except ThriftError:
                if len(buf) >= end - pos:
                    raise
                buf = raw_read(pos, min(len(buf) * 2, end - pos))
        if ph.type in (_PAGE_DATA, _PAGE_DATA_V2):
            if ph.num_values > remaining:
                raise ValueError(
                    f"page at {pos}: {ph.num_values} values exceeds "
                    f"chunk remainder {remaining}")
            remaining -= ph.num_values
        yield pos, ph
        pos += ph.header_len + ph.compressed_size


def _plan_levels(pos, ph, max_def: int, raw_read, may_null: bool):
    """Levels of a page whose levels are readable raw → (level_bytes,
    mask | None); mask is None when every value is present."""
    bw = max_def.bit_length()
    if ph.type == _PAGE_DATA_V2:
        lb = ph.def_levels_len + ph.rep_levels_len
        if not (may_null and ph.def_levels_len):
            return lb, None
        buf = raw_read(pos + ph.header_len + ph.rep_levels_len,
                       ph.def_levels_len)
        lev = decode_rle_hybrid(buf, bw, ph.num_values)
    else:
        if max_def == 0:
            return 0, None
        (n,) = struct.unpack("<I", raw_read(pos + ph.header_len, 4))
        lb = 4 + n
        if not may_null:
            return lb, None
        lev = decode_rle_hybrid(raw_read(pos + ph.header_len + 4, n),
                                bw, ph.num_values)
    mask = lev == max_def
    return lb, (None if mask.all() else np.asarray(mask))


def _index_stream_part(pos, ph, level_bytes: int, raw_read,
                       max_def: int = 0, n_valid: int = -1,
                       mask=None) -> PagePart:
    """Dict-encoded raw data-page body → index-stream PagePart
    (``<bit_width: 1 byte><RLE-hybrid runs>`` after the levels)."""
    val_off = pos + ph.header_len + level_bytes
    (bw,) = raw_read(val_off, 1)
    if bw > 32:
        raise ValueError(f"page at {pos}: bit width {bw} > 32")
    idx_len = ph.compressed_size - level_bytes - 1
    if idx_len < 0:
        raise ValueError(f"page at {pos}: negative index span")
    return PagePart("dict", (val_off + 1, idx_len), ph.num_values,
                    bit_width=bw, max_def=max_def, n_valid=n_valid,
                    mask=mask)


def _check_dict_page(pos, ph, already_seen: bool) -> None:
    if already_seen:
        raise ValueError(f"second dictionary page at {pos}")
    if ph.encoding not in (_ENC_PLAIN, _ENC_PLAIN_DICTIONARY):
        raise ValueError(
            f"dictionary page encoding {ph.encoding} not PLAIN")


def plan_chunk(meta, rg: int, ci: int, raw_read,
               allow_nulls: bool = False) -> ColumnPlan:
    """Walk the chunk's pages, returning exact value-byte spans (and the
    per-page masks where nulls are possible and allowed)."""
    col = meta.row_group(rg).column(ci)
    sc = meta.schema.column(ci)
    width = _WIDTHS[col.physical_type]
    max_def = sc.max_definition_level
    codec = _codec_of(col)
    st = col.statistics
    may_null = (max_def > 0
                and (st is None or st.null_count is None
                     or st.null_count != 0))
    if may_null and not allow_nulls:
        raise ValueError(
            f"rg{rg} col{ci}: possible nulls (pass nulls='mask')")
    parts: List[PagePart] = []
    dict_span: Optional[Tuple[int, int]] = None
    dict_count = 0
    dict_codec: Optional[str] = None
    dict_ulen = 0
    for pos, ph in _walk_pages(col, raw_read):
        if ph.type in (_PAGE_DATA, _PAGE_DATA_V2):
            v2 = ph.type == _PAGE_DATA_V2
            page_codec = codec
            if v2 and not ph.v2_is_compressed:
                page_codec = None
            if ph.encoding not in (_ENC_PLAIN, _ENC_BYTE_STREAM_SPLIT,
                                   *_DICT_ENCODINGS):
                raise ValueError(
                    f"page at {pos}: unsupported encoding {ph.encoding}")
            kind = {_ENC_PLAIN: "plain",
                    _ENC_BYTE_STREAM_SPLIT: "bss"}.get(ph.encoding, "dict")
            if kind == "dict" and dict_span is None:
                raise ValueError(
                    f"page at {pos}: dict-encoded data page before "
                    f"any dictionary page")
            if page_codec is not None and not v2:
                # v1: levels+values compressed as one body
                parts.append(PagePart(
                    kind, (pos + ph.header_len, ph.compressed_size),
                    ph.num_values, bit_width=-1, codec=page_codec,
                    uncompressed_len=ph.uncompressed_size,
                    inline_levels=max_def > 0, max_def=max_def))
                continue
            lb, mask = _plan_levels(pos, ph, max_def, raw_read, may_null)
            n_valid = int(mask.sum()) if mask is not None else -1
            vc = ph.num_values if n_valid < 0 else n_valid
            val_off = pos + ph.header_len + lb
            val_len = ph.compressed_size - lb
            if page_codec is not None:      # compressed v2 values region
                parts.append(PagePart(
                    kind, (val_off, val_len), ph.num_values,
                    bit_width=-1, codec=page_codec,
                    uncompressed_len=ph.uncompressed_size - lb,
                    max_def=max_def, n_valid=n_valid, mask=mask))
                continue
            if kind in ("plain", "bss"):
                want = vc * width
                if want + lb > ph.compressed_size:
                    raise ValueError(
                        f"page at {pos}: {vc} values x {width} + {lb} "
                        f"level bytes > page size {ph.compressed_size}")
                parts.append(PagePart(kind, (val_off, want),
                                      ph.num_values, max_def=max_def,
                                      n_valid=n_valid, mask=mask))
            else:
                parts.append(_index_stream_part(
                    pos, ph, lb, raw_read, max_def=max_def,
                    n_valid=n_valid, mask=mask))
        elif ph.type == _PAGE_DICTIONARY:
            _check_dict_page(pos, ph, dict_span is not None)
            if codec is not None:
                dict_span = (pos + ph.header_len, ph.compressed_size)
                dict_codec = codec
                dict_ulen = ph.uncompressed_size
                if ph.num_values * width > ph.uncompressed_size:
                    raise ValueError(
                        f"dictionary page at {pos}: {ph.num_values} "
                        f"values x {width} > uncompressed size "
                        f"{ph.uncompressed_size}")
            else:
                val_len = ph.num_values * width
                if val_len > ph.compressed_size:
                    raise ValueError(
                        f"dictionary page at {pos}: {ph.num_values} "
                        f"values x {width} > page size "
                        f"{ph.compressed_size}")
                dict_span = (pos + ph.header_len, val_len)
            dict_count = ph.num_values
        # INDEX pages are skipped silently
    return ColumnPlan(tuple(parts), col.num_values, col.physical_type,
                      dict_span=dict_span, dict_count=dict_count,
                      dict_codec=dict_codec,
                      dict_uncompressed_len=dict_ulen)


def decode_rle_hybrid(buf: bytes, bit_width: int, count: int):
    """Parquet RLE / bit-packed hybrid stream → int32 index array (host):
    the plain version of the device decode in ops/bitunpack.py.

    Each run is headed by a varint: low bit 1 → a bit-packed run of
    ``(header >> 1) * 8`` values (LSB first, decoded with
    ``np.unpackbits``); low bit 0 → an RLE run of ``header >> 1`` copies
    of one ``ceil(bit_width / 8)``-byte value.  Padding past ``count`` in
    the final run is dropped."""
    out = np.empty(count, np.int32)
    if bit_width == 0:
        out[:] = 0
        return out
    byte_w = (bit_width + 7) // 8
    weights = (np.int64(1) << np.arange(bit_width, dtype=np.int64))
    pos, filled, n = 0, 0, len(buf)
    while filled < count:
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
            bits = np.unpackbits(
                np.frombuffer(buf, np.uint8, nbytes, pos),
                bitorder="little")
            vals = bits.reshape(-1, bit_width).astype(np.int64) @ weights
            take = min(groups * 8, count - filled)
            out[filled:filled + take] = vals[:take]
            filled += take
            pos += nbytes
        else:                                # RLE run
            run = header >> 1
            if run == 0:
                raise ValueError("zero-length RLE run")
            if pos + byte_w > n:
                raise ValueError("truncated RLE run value")
            v = int.from_bytes(bytes(buf[pos:pos + byte_w]), "little")
            pos += byte_w
            take = min(run, count - filled)
            out[filled:filled + take] = v
            filled += take
    return out


def _name_to_ci(meta) -> Dict[str, int]:
    return {meta.schema.column(i).name: i for i in range(meta.num_columns)}


def plan_columns(scanner, columns: Sequence[str],
                 allow_nulls: bool = False
                 ) -> Dict[str, List[ColumnPlan]]:
    """Page-walk every (row group, column) chunk → value spans.  Raises
    ValueError naming the first chunk that is not direct-eligible."""
    meta = scanner.metadata
    name_to_ci = _name_to_ci(meta)
    with open(scanner.path, "rb") as f:
        def raw_read(off: int, ln: int) -> bytes:
            return os.pread(f.fileno(), ln, off)

        plans: Dict[str, List[ColumnPlan]] = {c: [] for c in columns}
        for rg in range(meta.num_row_groups):
            for c in columns:
                if c not in name_to_ci:
                    raise KeyError(f"column {c!r} not in schema")
                ci = name_to_ci[c]
                why = eligible_chunk(meta, rg, ci, allow_nulls=allow_nulls)
                if why is not None:
                    raise ValueError(
                        f"rg{rg}.{c} not direct-eligible: {why}")
                plans[c].append(plan_chunk(meta, rg, ci, raw_read,
                                           allow_nulls=allow_nulls))
    return plans


def _empty(physical_type: str, dev) -> torch.Tensor:
    return torch.zeros((0,), dtype=_TORCH_DTYPES[physical_type], device=dev)


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _stream_spans(scanner, ds, fh, spans, physical_type):
    """spans → one device tensor (concatenated and viewed on the device);
    spans larger than a staging buffer are read in chunk-sized pieces."""
    from nvme_strom_tpu_torch.ops.bridge import split_ranges
    ranges, _ = split_ranges(list(spans), scanner.engine.config.chunk_bytes)
    parts = list(ds.stream_ranges(fh, ranges))
    if not parts:
        return _empty(physical_type, ds.device)
    return _cat(parts).view(_TORCH_DTYPES[physical_type])


def _stream_raw_groups(scanner, ds, fh, spans):
    """spans → one uint8 device tensor PER SPAN, streamed as one pipelined
    range sequence (BSS pages decode per page)."""
    from nvme_strom_tpu_torch.ops.bridge import split_ranges
    flat, counts = split_ranges(list(spans),
                                scanner.engine.config.chunk_bytes)
    it = ds.stream_ranges(fh, flat)
    outs = []
    for n in counts:
        group = [next(it) for _ in range(n)]
        if not group:
            outs.append(torch.zeros((0,), dtype=torch.uint8,
                                    device=ds.device))
        else:
            outs.append(_cat(group))
    return outs


def _bss_decode(raw: torch.Tensor, n: int, physical_type: str):
    """BYTE_STREAM_SPLIT: the page bytes are (width, n) transposed; undo
    on the device, then view."""
    width = _WIDTHS[physical_type]
    return (raw[:n * width].reshape(width, n).t().contiguous().reshape(-1)
            .view(_TORCH_DTYPES[physical_type]))


def _index_from_body(body, count: int):
    """Dict index stream after levels: ``<bit_width byte><RLE runs>``."""
    bw = body[0]
    if bw > 32:
        raise ValueError(f"bit width {bw} > 32")
    return decode_rle_hybrid(bytes(body[1:]), bw, count)


def _with_span(engine, fh, off: int, ln: int, fn):
    """``fn(view)`` over the bytes [off, off + ln) of an open file, read
    through the engine.  A span within one staging buffer is handed over
    in place (no host copy); a longer one is joined on the host, and the
    join counted as bounce."""
    chunk = engine.config.chunk_bytes
    if ln <= chunk:
        pr = engine.submit_read(fh, off, ln, klass=SCAN_CLASS)
        try:
            view = pr.wait()
            if view.nbytes != ln:
                raise ValueError(f"short read at {off}: {view.nbytes} of "
                                 f"{ln} bytes")
            return fn(view)
        finally:
            pr.release()
    return fn(_read_span_bytes(engine, fh, off, ln))


def _read_span_bytes(engine, fh, off: int, ln: int) -> bytes:
    """Engine read of a control-stream span → owning host bytes; the copy
    out of staging is counted as bounce (index streams, level blocks)."""
    chunk = engine.config.chunk_bytes
    pend = [engine.submit_read(fh, pos, min(chunk, off + ln - pos),
                               klass=SCAN_CLASS)
            for pos in range(off, off + ln, chunk)]
    out = []
    try:
        for p in pend:
            out.append(p.wait().tobytes())
    finally:
        for p in pend:
            p.release()
    data = out[0] if len(out) == 1 else b"".join(out)
    engine.stats.add(bounce_bytes=len(data))
    return data


def _decompress_span(eng, fh, span, codec: str, out_len: int) -> bytes:
    """A compressed span read through the engine and decompressed on the
    host straight from the staging buffer."""
    return _with_span(eng, fh, span[0], span[1],
                      lambda v: _decompress(codec, v, out_len))


def _put_control(eng, arr, dev) -> torch.Tensor:
    """Host-decoded control data (masks, index arrays) or decompressed
    values → device; ``host_to_device`` counts them as bounce."""
    from nvme_strom_tpu_torch.ops.bridge import to_device
    return to_device(eng, np.ascontiguousarray(arr), dev)


def _decode_one_index_stream(eng, fh, p: PagePart, dev):
    """One dict-kind PagePart → int32 host index array (raw span, or a
    compressed body whose levels and bit width are read after the
    decompress).  Nulls are refused: callers planned the chunk
    null-free."""
    if p.codec is None:
        buf = _read_span_bytes(eng, fh, *p.span)
        return decode_rle_hybrid(buf, p.bit_width, p.valid_count)
    body = _decompress_span(eng, fh, p.span, p.codec, p.uncompressed_len)
    if dev.type != "cpu":
        eng.stats.add(bounce_bytes=p.uncompressed_len)
    n_valid = p.valid_count
    if p.inline_levels:
        body, mask, n_valid = _inline_levels(body, p)
        if mask is not None:
            raise ValueError(
                "unexpected nulls in a chunk planned null-free")
    return _index_from_body(body, n_valid)


def _check_range_dev(idx: torch.Tensor, dict_count: int) -> None:
    """Dictionary indices must lie in [0, dict_count): an index out of
    range would gather the wrong row (or raise on the device)."""
    if idx.numel():
        lo, hi = (int(x) for x in torch.stack([idx.min(), idx.max()])
                  .cpu())
        if lo < 0 or hi >= dict_count:
            raise ValueError(
                f"dictionary index {lo if lo < 0 else hi} out of range "
                f"[0, {dict_count})")


def _raw_indices_to_device(eng, fh, parts, dev):
    """Raw dict-kind PageParts → ONE int32 device index tensor, or None
    when the device decode declines (bit width > 24, too many runs).

    Each index stream is read into a staging buffer; the host parses its
    run headers from the staging view (no copy) while ``h2d_copy`` copies
    the same bytes to the device, so the stream is never copied on the
    host: the only host-built bytes are the run table (bounce).  Spans
    longer than one staging buffer are joined on the host (bounce)."""
    from nvme_strom_tpu_torch.ops.bitunpack import RunTable
    from nvme_strom_tpu_torch.ops.bridge import host_to_device
    table = RunTable()
    pieces = []
    chunk = eng.config.chunk_bytes
    window = max(1, min(8, eng.n_buffers // 4))
    for lo in range(0, len(parts), window):
        batch = parts[lo:lo + window]
        prs = [eng.submit_read(fh, p.span[0], p.span[1], klass=SCAN_CLASS)
               if 0 < p.span[1] <= chunk else None for p in batch]
        transfers = []
        try:
            for p, pr in zip(batch, prs):
                if pr is not None:
                    buf = pr.wait()
                elif p.span[1]:
                    buf = _read_span_bytes(eng, fh, *p.span)
                else:
                    buf = b""
                need = table.add(buf, p.bit_width, p.valid_count)
                if need is None:
                    return None
                if need:
                    t = host_to_device(eng, np.frombuffer(buf, np.uint8)
                                       if isinstance(buf, bytes) else buf,
                                       dev)
                    transfers.append(t)
                    pieces.append(t.tensor)
        finally:
            for t in transfers:
                t.synchronize()
            for pr in prs:
                if pr is not None:
                    pr.release()
    u8 = _cat(pieces) if pieces else None
    return table.decode(u8, dev, eng)


def _indices_to_device(eng, fh, parts, dict_count: int, dev):
    """Dict-kind PageParts → one validated int32 device index tensor.

    Raw streams decode on the device (:func:`_raw_indices_to_device`);
    if the device declines, they decode on the host; compressed bodies
    go through :func:`_decode_one_index_stream`."""
    dev_parts = []
    raw_batch = []     # consecutive raw pages decode as ONE program

    def flush_raw():
        if not raw_batch:
            return
        d = _raw_indices_to_device(eng, fh, raw_batch, dev)
        if d is not None:
            dev_parts.append(d)
        else:
            for p in raw_batch:
                buf = _read_span_bytes(eng, fh, *p.span)
                dev_parts.append(_put_control(
                    eng, decode_rle_hybrid(buf, p.bit_width,
                                           p.valid_count), dev))
        raw_batch.clear()

    for p in parts:
        if p.is_raw:
            raw_batch.append(p)
        else:
            flush_raw()
            dev_parts.append(_put_control(
                eng, _decode_one_index_stream(eng, fh, p, dev), dev))
    flush_raw()
    if not dev_parts:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    idx = _cat(dev_parts)
    _check_range_dev(idx, dict_count)
    return idx


def _gather(dict_dev: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``dictionary[idx]``, the indices already range-checked."""
    return dict_dev[idx.to(torch.int64)]


def _scatter_masked(vals_dev, mask_np, eng, dev):
    """Dense non-null values → full-length page output, on the device:
    slot i reads dense index cumsum(mask)[i] - 1; null slots are zeroed.
    Returns (full values, device mask)."""
    m = _put_control(eng, mask_np.astype(np.bool_), dev)
    pos = torch.cumsum(m.to(torch.int64), 0) - 1
    n = mask_np.shape[0]
    if vals_dev.shape[0] == 0:
        return torch.zeros(n, dtype=vals_dev.dtype, device=dev), m
    full = vals_dev[pos.clamp(min=0)]
    return torch.where(m, full, torch.zeros((), dtype=full.dtype,
                                            device=dev)), m


def _inline_levels(body, p: PagePart):
    """A compressed v1 page's level block, parsed from its decompressed
    body → (values view, mask | None, n_valid)."""
    (n,) = struct.unpack_from("<I", body, 0)
    if 4 + n > len(body):
        raise ValueError("level block overruns decompressed page body")
    lev = decode_rle_hybrid(bytes(body[4:4 + n]),
                            p.max_def.bit_length(), p.num_values)
    mask = np.asarray(lev == p.max_def)
    vals = memoryview(body)[4 + n:]
    if mask.all():
        return vals, None, p.num_values
    return vals, mask, int(mask.sum())


def _decode_special_part(scanner, ds, fh, p: PagePart, plan, dict_dev,
                         dev):
    """One non-raw page (codec and/or mask) → (device values, mask).

    Compressed bytes ride the engine, decompress on the host and decode
    on the device; raw-but-masked pages keep the zero-copy value stream
    and only the mask is host-decoded."""
    eng = scanner.engine
    width = _WIDTHS[plan.physical_type]
    np_dtype = np.dtype(_NP_DTYPES[plan.physical_type])
    mask, n_valid = p.mask, p.valid_count

    if p.codec is not None:
        body = _decompress_span(eng, fh, p.span, p.codec,
                                p.uncompressed_len)
        if p.inline_levels:
            body, mask, n_valid = _inline_levels(body, p)
        if p.kind == "dict":
            if dev.type != "cpu":
                eng.stats.add(bounce_bytes=p.uncompressed_len)
            idx = _index_from_body(body, n_valid)
            _check_index_range(idx, plan.dict_count)
            vals = _gather(dict_dev, _put_control(eng, idx, dev))
        elif p.kind == "bss":
            u8 = _put_control(eng, np.frombuffer(body, np.uint8,
                                                 n_valid * width), dev)
            vals = _bss_decode(u8, n_valid, plan.physical_type)
        else:
            arr = np.frombuffer(body, np_dtype, n_valid)
            vals = _put_control(eng, arr, dev)
    else:
        if p.kind == "dict":
            buf = _read_span_bytes(eng, fh, *p.span)
            idx = decode_rle_hybrid(buf, p.bit_width, n_valid)
            _check_index_range(idx, plan.dict_count)
            vals = _gather(dict_dev, _put_control(eng, idx, dev))
        elif p.kind == "bss":
            (raw,) = _stream_raw_groups(scanner, ds, fh, [p.span])
            vals = _bss_decode(raw, n_valid, plan.physical_type)
        else:
            vals = _stream_spans(scanner, ds, fh, [p.span],
                                 plan.physical_type)
    if mask is not None:
        return _scatter_masked(vals, mask, eng, dev)
    return vals, None


def _check_index_range(idx, dict_count: int) -> None:
    if idx.size:
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= dict_count:
            raise ValueError(
                f"dictionary index {lo if lo < 0 else hi} out of range "
                f"[0, {dict_count})")


def _raw_dict_only(plans: Sequence[ColumnPlan]) -> bool:
    """Every row group a raw, null-free dictionary-encoded chunk with a
    raw PLAIN dictionary page — the shape the whole-column batched path
    handles."""
    return all(
        plan.parts and plan.dict_span is not None
        and plan.dict_codec is None
        and all(p.kind == "dict" and p.is_raw for p in plan.parts)
        for plan in plans)


def _dict_combine(big_dict, idx, bases, counts, rows_per_chunk):
    """Whole-column dictionary decode: each row's chunk base offset and
    dictionary size broadcast with ``repeat_interleave``, one range check
    and one gather → (values, any index out of range)."""
    n = idx.shape[0]
    off = torch.repeat_interleave(bases, rows_per_chunk, output_size=n)
    cnt = torch.repeat_interleave(counts, rows_per_chunk, output_size=n)
    idx64 = idx.to(torch.int64)
    bad = ((idx64 < 0) | (idx64 >= cnt)).any()
    safe = torch.where((idx64 < 0) | (idx64 >= cnt),
                       torch.zeros_like(idx64), idx64)
    return big_dict[safe + off], bad


def _read_dict_column_batched(scanner, ds, fh,
                              plans: Sequence[ColumnPlan], dev):
    """ALL row groups of a raw dictionary-encoded column at once: one
    stream of every chunk's dictionary page, ONE device decode across
    every chunk's index runs (on the host where the device declines),
    and one combine that adds each chunk's dictionary base, range-checks
    and gathers — one host sync for the column."""
    eng = scanner.engine
    parts = [p for plan in plans for p in plan.parts]
    rows_per_chunk = [sum(p.valid_count for p in plan.parts)
                      for plan in plans]
    idx = _raw_indices_to_device(eng, fh, parts, dev)
    if idx is None:
        idx = torch.cat([_indices_to_device(eng, fh, plan.parts,
                                            plan.dict_count, dev)
                         for plan in plans])
    big_dict = _stream_spans(scanner, ds, fh,
                             [plan.dict_span for plan in plans],
                             plans[0].physical_type)
    counts = np.fromiter((plan.dict_count for plan in plans), np.int64)
    bases = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=bases[1:])
    vals, bad = _dict_combine(
        big_dict, idx, torch.as_tensor(bases, device=dev),
        torch.as_tensor(counts, device=dev),
        torch.as_tensor(np.asarray(rows_per_chunk, np.int64), device=dev))
    if bool(bad):              # the column's one host sync
        raise ValueError(
            f"dictionary index out of range (column of "
            f"{len(plans)} row groups)")
    return vals


def _assemble_chunk(scanner, ds, fh, plan: ColumnPlan, dev):
    """One column chunk → (device values, device mask | None), pages in
    order: raw plain and BSS pages stream zero-copy, raw dictionary pages
    gather on the device, compressed or masked pages go through
    :func:`_decode_special_part`."""
    eng = scanner.engine
    dict_dev = None
    if any(p.kind == "dict" for p in plan.parts):
        if plan.dict_codec is not None:
            body = _decompress_span(eng, fh, plan.dict_span,
                                    plan.dict_codec,
                                    plan.dict_uncompressed_len)
            arr = np.frombuffer(body,
                                np.dtype(_NP_DTYPES[plan.physical_type]),
                                plan.dict_count)
            dict_dev = _put_control(eng, arr, dev)
        else:
            dict_dev = _stream_spans(scanner, ds, fh, [plan.dict_span],
                                     plan.physical_type)
    segs = []            # (device tensor, mask | None) in page order
    pending_dict = []
    pending_plain = []
    pending_bss = []

    def flush_dict():
        if pending_dict:
            idx = _indices_to_device(eng, fh, pending_dict,
                                     plan.dict_count, dev)
            segs.append((_gather(dict_dev, idx), None))
            pending_dict.clear()

    def flush_plain():
        if pending_plain:
            segs.append((_stream_spans(scanner, ds, fh,
                                       list(pending_plain),
                                       plan.physical_type), None))
            pending_plain.clear()

    def flush_bss():
        if pending_bss:
            width = _WIDTHS[plan.physical_type]
            for raw in _stream_raw_groups(scanner, ds, fh,
                                          list(pending_bss)):
                segs.append((_bss_decode(raw, raw.shape[0] // width,
                                         plan.physical_type), None))
            pending_bss.clear()

    def flush_all():
        flush_dict()
        flush_plain()
        flush_bss()

    flushes = {"plain": (flush_dict, flush_bss),
               "dict": (flush_plain, flush_bss),
               "bss": (flush_dict, flush_plain)}
    for p in plan.parts:
        if not p.is_raw:
            flush_all()          # page order is the output order
            segs.append(_decode_special_part(scanner, ds, fh, p, plan,
                                             dict_dev, dev))
            continue
        for fl in flushes[p.kind]:
            fl()
        if p.kind == "plain":
            pending_plain.append(p.span)
        elif p.kind == "bss":
            pending_bss.append(p.span)
        else:
            pending_dict.append(p)
    flush_all()
    if not segs:
        return _empty(plan.physical_type, dev), None
    vals = _cat([s[0] for s in segs])
    if all(m is None for _, m in segs):
        return vals, None
    mask = torch.cat([
        m if m is not None else torch.ones((a.shape[0],), dtype=torch.bool,
                                           device=dev)
        for a, m in segs])
    return vals, mask


def _plain_only(plans: Sequence[ColumnPlan]) -> bool:
    return all(p.kind == "plain" and p.is_raw
               for plan in plans for p in plan.parts)


def try_plan(scanner, columns: Sequence[str], allow_nulls: bool = False):
    """plan_columns, or None when the file is not direct-eligible — the
    one fallback rule every consumer shares."""
    if not hasattr(scanner, "direct_reasons"):
        return None
    try:
        return plan_columns(scanner, columns, allow_nulls=allow_nulls)
    except ValueError:
        return None


def _compressed_plain_only(plans: Sequence[ColumnPlan]) -> bool:
    """Every page a codec-tagged null-free PLAIN body."""
    return all(p.kind == "plain" and p.codec is not None
               and p.mask is None
               for plan in plans for p in plan.parts)


def _iter_span_views_pipelined(eng, fh, spans):
    """Yield a host view per span with the engine queue kept full ACROSS
    spans: the sub-chunk reads of later spans are submitted (up to the
    queue depth) while earlier spans decompress.  A view within one
    staging buffer is valid until the consumer asks for the next one; a
    span split over several buffers is joined on the host (bounce)."""
    from collections import deque
    from nvme_strom_tpu_torch.ops.bridge import split_ranges
    flat, n_chunks = split_ranges(list(spans), eng.config.chunk_bytes)
    pend = deque()
    qd = max(1, min(eng.config.queue_depth, eng.n_buffers // 2))
    it = iter(flat)

    def fill():
        while len(pend) < qd:
            r = next(it, None)
            if r is None:
                return
            pend.append(eng.submit_read(fh, r[0], r[1], klass=SCAN_CLASS))

    try:
        for n in n_chunks:
            fill()
            prs = [pend.popleft() for _ in range(n)] if n else []
            while len(prs) < n:      # wider than the queue: read on
                fill()
                prs.append(pend.popleft())
            try:
                views = [p.wait() for p in prs]
                if len(views) == 1:
                    yield views[0]
                else:
                    data = b"".join(v.tobytes() for v in views)
                    eng.stats.add(bounce_bytes=len(data))
                    yield data
            finally:
                for p in prs:
                    p.release()
    finally:
        for p in pend:
            try:
                p.wait()
            except OSError:
                pass
            p.release()


def _read_compressed_plain_pipelined(scanner, fh, columns, plans, dev):
    """All-compressed-PLAIN scan: pipelined O_DIRECT page reads, host
    decompression from the staging buffers overlapped with the reads in
    flight, and one device copy per (column, row group)."""
    eng = scanner.engine
    work = [(c, gi, p) for c in columns
            for gi, plan in enumerate(plans[c])
            for p in plan.parts]
    widths = {c: _WIDTHS[plans[c][0].physical_type] for c in columns}
    dev_parts: Dict[str, list] = {c: [] for c in columns}
    group_bodies: list = []

    def flush_group(c):
        if group_bodies:
            arr = np.frombuffer(b"".join(group_bodies), np.dtype(
                _NP_DTYPES[plans[c][0].physical_type]))
            group_bodies.clear()
            dev_parts[c].append(_put_control(eng, arr, dev))

    it = _iter_span_views_pipelined(eng, fh, [p.span for _, _, p in work])
    prev = None
    for (c, gi, p), raw in zip(work, it):
        if prev is not None and prev != (c, gi):
            flush_group(prev[0])
        prev = (c, gi)
        body = _decompress(p.codec, raw, p.uncompressed_len)
        n_valid = p.valid_count
        if p.inline_levels:
            body, mask, n_valid = _inline_levels(body, p)
            if mask is not None:
                raise ValueError(
                    "unexpected nulls in a chunk planned null-free")
        group_bodies.append(bytes(body[:n_valid * widths[c]]))
    if prev is not None:
        flush_group(prev[0])
    return {c: (_cat(dev_parts[c]) if dev_parts[c]
                else _empty(plans[c][0].physical_type, dev))
            for c in columns}


def _join_chunks(chunks, nulls: str, column: str):
    """[(values, mask | None)] per row group → the column under the
    ``nulls`` policy: "forbid" raises on any mask, "mask" returns
    (values, mask)."""
    vals = _cat([c[0] for c in chunks])
    if nulls == "forbid":
        if any(m is not None for _, m in chunks):
            raise ValueError(
                f"column {column!r} has nulls; pass nulls='mask'")
        return vals
    dev = vals.device
    if all(m is None for _, m in chunks):
        mask = torch.ones((vals.shape[0],), dtype=torch.bool, device=dev)
    else:
        mask = torch.cat([
            m if m is not None else torch.ones((a.shape[0],),
                                               dtype=torch.bool, device=dev)
            for a, m in chunks])
    return vals, mask


def _scan_stream(scanner, dev):
    from nvme_strom_tpu_torch.ops.bridge import DeviceStream
    return DeviceStream(scanner.engine, device=dev, klass=SCAN_CLASS)


def read_plain_columns_to_device(scanner, columns: Sequence[str],
                                 device=None, plans=None,
                                 nulls: str = "forbid"
                                 ) -> Dict[str, object]:
    """Direct scan of the whole file: {name: device tensor}, row groups
    joined on the device.  ``plans`` reuses a prior
    :func:`plan_columns` walk.  ``nulls``: "forbid" (default) raises if
    any chunk holds nulls; "mask" returns ``(values, valid_mask)`` pairs,
    null slots zero."""
    from nvme_strom_tpu_torch.device import resolve_device

    if nulls not in ("forbid", "mask"):
        raise ValueError(f"bad nulls={nulls!r}")
    dev = resolve_device(device)
    plans = plans or plan_columns(scanner, columns,
                                  allow_nulls=nulls == "mask")
    ds = _scan_stream(scanner, dev)
    out = {}
    meta = scanner.metadata
    name_to_ci = _name_to_ci(meta)
    fh = scanner.engine.open(scanner.path)
    try:
        if (nulls == "forbid" and columns
                and all(plans[c] and _plain_only(plans[c])
                        for c in columns)):
            # ONE pipelined range sequence across every chunk
            per_col = {c: [] for c in columns}
            for rg_out in _iter_plain_pipelined(
                    scanner, ds, fh, columns, plans,
                    range(meta.num_row_groups)):
                for c, v in rg_out.items():
                    per_col[c].append(v)
            return {c: _cat(parts) for c, parts in per_col.items()}
        if (nulls == "forbid" and columns
                and all(plans[c] and _compressed_plain_only(plans[c])
                        for c in columns)):
            return _read_compressed_plain_pipelined(scanner, fh,
                                                    columns, plans, dev)
        for c in columns:
            if not plans[c]:   # zero row groups: empty typed column
                pt = meta.schema.column(name_to_ci[c]).physical_type
                empty = _empty(pt, dev)
                out[c] = (empty if nulls == "forbid"
                          else (empty, torch.zeros((0,), dtype=torch.bool,
                                                   device=dev)))
            elif _plain_only(plans[c]) and nulls == "forbid":
                out[c] = _stream_spans(
                    scanner, ds, fh,
                    [s for p in plans[c] for s in p.spans],
                    plans[c][0].physical_type)
            elif nulls == "forbid" and _raw_dict_only(plans[c]):
                out[c] = _read_dict_column_batched(scanner, ds, fh,
                                                   plans[c], dev)
            else:
                chunks = [_assemble_chunk(scanner, ds, fh, plan, dev)
                          for plan in plans[c]]
                out[c] = _join_chunks(chunks, nulls, c)
    finally:
        scanner.engine.close(fh)
    return out


# -- dictionary-code scans of BYTE_ARRAY (string) columns -----------------
#
# GROUP BY over strings never puts the strings on the device: the device
# groups by the dictionary CODE (int32) and the host maps codes back to
# labels from the dictionary pages it already parsed.


@dataclass(frozen=True)
class DictCodeChunk:
    """One chunk of a dictionary-coded BYTE_ARRAY column."""
    parts: Tuple[PagePart, ...]            # all kind "dict"
    num_values: int
    dict_span: Tuple[int, int]             # raw dictionary page body
    dict_count: int
    dict_codec: Optional[str] = None
    dict_uncompressed_len: int = 0


def dict_code_eligible(meta, rg: int, ci: int) -> Optional[str]:
    """None if the chunk can scan as dictionary codes, else the reason."""
    col = meta.row_group(rg).column(ci)
    sc = meta.schema.column(ci)
    if col.physical_type != "BYTE_ARRAY":
        return f"physical type {col.physical_type} (need BYTE_ARRAY)"
    codec = _codec_of(col)
    if codec is not None and not _codec_available(codec):
        return f"compression {col.compression}"
    encs = set(col.encodings)
    if not encs <= {"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY"}:
        return f"encodings {sorted(encs)}"
    if (col.dictionary_page_offset or 0) <= 0:
        return "no dictionary page"
    if sc.max_repetition_level != 0:
        return "repeated field"
    if sc.max_definition_level > 0:
        st = col.statistics
        if st is None or st.null_count is None:
            return "no null statistics"
        if st.null_count != 0:
            return f"{st.null_count} nulls"
    return None


def plan_dict_code_chunk(meta, rg: int, ci: int, raw_read) -> DictCodeChunk:
    """Page-walk a BYTE_ARRAY chunk: the dictionary page's span and the
    index streams' spans.  Raises ValueError on any PLAIN data page
    (dictionary overflow): string bytes cannot decode on the device."""
    col = meta.row_group(rg).column(ci)
    sc = meta.schema.column(ci)
    max_def = sc.max_definition_level
    codec = _codec_of(col)
    parts: List[PagePart] = []
    dict_span = None
    dict_count = 0
    dict_codec: Optional[str] = None
    dict_ulen = 0
    for pos, ph in _walk_pages(col, raw_read):
        if ph.type in (_PAGE_DATA, _PAGE_DATA_V2):
            if ph.encoding not in _DICT_ENCODINGS:
                raise ValueError(
                    f"page at {pos}: encoding {ph.encoding} — string "
                    f"chunk fell back from dictionary (overflow?)")
            if dict_span is None:
                raise ValueError(
                    f"page at {pos}: dict-encoded data page before "
                    f"any dictionary page")
            v2 = ph.type == _PAGE_DATA_V2
            page_codec = codec
            if v2 and not ph.v2_is_compressed:
                page_codec = None
            if page_codec is not None and not v2:
                parts.append(PagePart(
                    "dict", (pos + ph.header_len, ph.compressed_size),
                    ph.num_values, bit_width=-1, codec=page_codec,
                    uncompressed_len=ph.uncompressed_size,
                    inline_levels=max_def > 0, max_def=max_def))
                continue
            lb, _ = _plan_levels(pos, ph, max_def, raw_read, False)
            if page_codec is not None:
                parts.append(PagePart(
                    "dict",
                    (pos + ph.header_len + lb, ph.compressed_size - lb),
                    ph.num_values, bit_width=-1, codec=page_codec,
                    uncompressed_len=ph.uncompressed_size - lb,
                    max_def=max_def))
            else:
                parts.append(_index_stream_part(pos, ph, lb, raw_read,
                                                max_def=max_def))
        elif ph.type == _PAGE_DICTIONARY:
            _check_dict_page(pos, ph, dict_span is not None)
            dict_span = (pos + ph.header_len, ph.compressed_size)
            dict_count = ph.num_values
            if codec is not None:
                dict_codec = codec
                dict_ulen = ph.uncompressed_size
    if dict_span is None:
        raise ValueError(f"rg{rg} col{ci}: no dictionary page")
    return DictCodeChunk(tuple(parts), col.num_values, dict_span,
                         dict_count, dict_codec=dict_codec,
                         dict_uncompressed_len=dict_ulen)


def parse_byte_array_dict(buf, count: int) -> List[bytes]:
    """PLAIN BYTE_ARRAY values (``<u32 len><bytes>`` repeated)."""
    out: List[bytes] = []
    pos = 0
    for _ in range(count):
        if pos + 4 > len(buf):
            raise ValueError("truncated dictionary page (length prefix)")
        (n,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if pos + n > len(buf):
            raise ValueError("truncated dictionary page (entry bytes)")
        out.append(bytes(buf[pos:pos + n]))
        pos += n
    return out


def read_dict_key_column(scanner, column: str, device=None,
                         row_groups=None):
    """A BYTE_ARRAY column prepared for GROUP BY by code.

    Returns ``(labels, iter_codes)``: ``labels``, the global label list
    (every row group's dictionary, first-seen order, as bytes), and
    ``iter_codes()``, which yields one int32 device tensor of global codes
    per row group in ``row_groups`` (default: all).  The dictionary pages
    are read first (host-touched, so bounce), so each row group's local
    codes map to global ones on the device."""
    from nvme_strom_tpu_torch.device import resolve_device

    meta = scanner.metadata
    name_to_ci = _name_to_ci(meta)
    if column not in name_to_ci:
        raise KeyError(f"column {column!r} not in schema")
    ci = name_to_ci[column]
    with open(scanner.path, "rb") as f:
        def raw_read(off: int, ln: int) -> bytes:
            return os.pread(f.fileno(), ln, off)

        chunks = []
        for rg in range(meta.num_row_groups):
            why = dict_code_eligible(meta, rg, ci)
            if why is not None:
                raise ValueError(
                    f"rg{rg}.{column} not dict-code-eligible: {why}")
            chunks.append(plan_dict_code_chunk(meta, rg, ci, raw_read))

    dev = resolve_device(device)
    eng = scanner.engine
    labels: List[bytes] = []
    gid: Dict[bytes, int] = {}
    remaps: List[torch.Tensor] = []
    fh = eng.open(scanner.path)
    try:
        for ch in chunks:
            if ch.dict_codec is not None:
                body = _decompress_span(eng, fh, ch.dict_span,
                                        ch.dict_codec,
                                        ch.dict_uncompressed_len)
                eng.stats.add(bounce_bytes=ch.dict_uncompressed_len)
            else:
                body = _read_span_bytes(eng, fh, *ch.dict_span)
            local = parse_byte_array_dict(body, ch.dict_count)
            remap = np.empty(max(ch.dict_count, 1), np.int32)
            for i, lab in enumerate(local):
                if lab not in gid:
                    gid[lab] = len(labels)
                    labels.append(lab)
                remap[i] = gid[lab]
            remaps.append(_put_control(eng, remap, dev))
    finally:
        eng.close(fh)

    selected = (range(len(chunks)) if row_groups is None
                else list(row_groups))

    def iter_codes():
        fh = eng.open(scanner.path)
        try:
            for rg in selected:
                ch, remap_dev = chunks[rg], remaps[rg]
                idx = _indices_to_device(eng, fh, ch.parts,
                                         ch.dict_count, dev)
                yield _gather(remap_dev, idx)
        finally:
            eng.close(fh)

    return labels, iter_codes


def iter_plain_row_groups_to_device(scanner, columns: Sequence[str],
                                    device=None, plans=None,
                                    row_groups=None,
                                    nulls: str = "forbid",
                                    window_bytes: Optional[int] = None):
    """Yield {name: device tensor} per (selected) row group — the form the
    GROUP BY folds over, so device memory holds one row group (or one
    window) of columns at a time.  ``row_groups`` restricts to a pruned
    subset.  ``nulls`` as in :func:`read_plain_columns_to_device`.

    ``window_bytes`` batches consecutive row groups into one yield of
    about that many payload bytes (all-PLAIN ``forbid`` path only), for
    FOLD consumers; positional consumers (top-k, LIMIT scans) leave it
    None.  When every selected chunk is raw PLAIN the whole scan is one
    pipelined range sequence: row-group boundaries are only chunk counts
    on the consumer's side."""
    from nvme_strom_tpu_torch.device import resolve_device

    if nulls not in ("forbid", "mask"):
        raise ValueError(f"bad nulls={nulls!r}")
    dev = resolve_device(device)
    plans = plans or plan_columns(scanner, columns,
                                  allow_nulls=nulls == "mask")
    ds = _scan_stream(scanner, dev)
    fh = scanner.engine.open(scanner.path)
    try:
        groups = (range(scanner.metadata.num_row_groups)
                  if row_groups is None else row_groups)
        groups = list(groups)
        if nulls == "forbid" and all(
                _plain_only([plans[c][rg]])
                for rg in groups for c in columns):
            yield from _iter_plain_pipelined(scanner, ds, fh, columns,
                                             plans, groups,
                                             window_bytes=window_bytes)
            return
        for rg in groups:
            out = {}
            for c in columns:
                plan = plans[c][rg]
                if _plain_only([plan]) and nulls == "forbid":
                    out[c] = _stream_spans(scanner, ds, fh, plan.spans,
                                           plan.physical_type)
                else:
                    out[c] = _join_chunks(
                        [_assemble_chunk(scanner, ds, fh, plan, dev)],
                        nulls, c)
            yield out
    finally:
        scanner.engine.close(fh)


def _iter_plain_pipelined(scanner, ds, fh, columns, plans, groups,
                          window_bytes: Optional[int] = None):
    """All-raw-PLAIN scan as ONE pipelined range sequence: the engine keeps
    ``depth`` reads in flight across row-group boundaries and the consumer
    reassembles the boundaries from chunk counts."""
    flat, counts, windows = [], [], _split_windows(columns, plans,
                                                   groups, window_bytes)
    for w in windows:
        f, cn = _plan_window_ranges(scanner, columns, plans, w)
        flat.extend(f)
        counts.extend(cn)
    it = ds.stream_ranges(fh, flat)
    ci = iter(counts)
    try:
        for w in windows:
            yield _assemble_window(columns, plans, w, ci, it)
    finally:
        it.close()


def _split_windows(columns, plans, groups,
                   window_bytes: Optional[int]) -> list:
    """Row-group ids → consecutive windows of ~``window_bytes`` payload
    (one group a window when None / 0): the one windowing rule of the
    serial and the partition-parallel scans."""
    if window_bytes:
        windows, cur, cur_b = [], [], 0
        for rg in groups:
            b = sum(ln for c in columns for _, ln in plans[c][rg].spans)
            if cur and cur_b + b > window_bytes:
                windows.append(cur)
                cur, cur_b = [], 0
            cur.append(rg)
            cur_b += b
        if cur:
            windows.append(cur)
        return windows
    return [[rg] for rg in groups]


def _plan_window_ranges(scanner, columns, plans, w):
    """One window's submission plan: ``(flat, counts)`` — every chunk-sized
    sub-range in submission order, plus the ``(rg, column, n_chunks,
    spec)`` records :func:`_assemble_window` consumes."""
    from nvme_strom_tpu_torch.ops.bridge import split_ranges

    chunk_bytes = scanner.engine.config.chunk_bytes
    flat = []
    counts = []
    allow = {c: sum(len([s for s in plans[c][rg].spans if s[1]])
                    for rg in w) <= _COALESCE_MAX_SLICES
             for c in columns}
    for rg in w:
        for c in columns:
            spans = plans[c][rg].spans
            merged = _coalesce_spans(spans) if allow[c] else None
            if merged is not None:
                ranges, _ = split_ranges([merged], chunk_bytes)
                spec = tuple((off - merged[0], ln)
                             for off, ln in spans if ln)
            else:
                ranges, _ = split_ranges(list(spans), chunk_bytes)
                spec = None
            flat.extend(ranges)
            counts.append((rg, c, len(ranges), spec))
    return flat, counts


def _assemble_window(columns, plans, w, ci, it):
    """One window's {column: device tensor} from its ``counts`` records
    (``ci``) and streamed buffers (``it``)."""
    parts: dict = {c: [] for c in columns}
    specs: dict = {c: [] for c in columns}
    merged_any = {c: False for c in columns}
    sizes = {c: 0 for c in columns}
    dev = None
    for rg in w:
        for c in columns:
            _, _, n, spec = next(ci)
            got = [next(it) for _ in range(n)]
            base = sizes[c]
            if spec is not None:
                merged_any[c] = True
                specs[c].extend((base + o, ln) for o, ln in spec)
            else:
                pos = 0
                for p in got:
                    specs[c].append((base + pos, int(p.shape[0])))
                    pos += int(p.shape[0])
            parts[c].extend(got)
            if got:
                dev = got[0].device
            sizes[c] += sum(int(p.shape[0]) for p in got)
    out = {}
    for c in columns:
        pt = plans[c][w[0]].physical_type
        ps = parts[c]
        if not ps:
            out[c] = _empty(pt, dev if dev is not None else "cpu")
            continue
        buf = _cat(ps)
        if merged_any[c]:
            buf = _degap(tuple(specs[c]), buf)
        out[c] = buf.view(_TORCH_DTYPES[pt])
    return out


#: tolerated header overhead when streaming a column chunk's enclosing
#: range (page headers are ~30-60 B a ~1 MiB page)
_COALESCE_GAP_FRAC = 0.05

#: most value spans one window-column degap joins
_COALESCE_MAX_SLICES = 256


def _coalesce_spans(spans):
    """Enclosing (offset, length) of the span list when the interior gaps
    (page headers) are a negligible fraction — else None."""
    spans = [s for s in spans if s[1]]
    if len(spans) < 2:
        return None
    lo = spans[0][0]
    hi = spans[-1][0] + spans[-1][1]
    payload = sum(ln for _, ln in spans)
    if hi - lo - payload > _COALESCE_GAP_FRAC * payload:
        return None
    pos = lo
    for off, ln in spans:
        if off < pos:
            return None
        pos = off + ln
    return (lo, hi - lo)


def _degap(spec: tuple, buf: torch.Tensor) -> torch.Tensor:
    """uint8 buffer → the concatenation of the ``spec`` (offset, length)
    value spans, on the buffer's device."""
    pieces = [buf[o:o + ln] for o, ln in spec]
    return pieces[0].clone() if len(pieces) == 1 else torch.cat(pieces)
