"""The port's Arrow IPC reader and writer (nvme_strom_tpu_torch/formats/
arrow.py, no pyarrow) held against ``pyarrow.ipc`` and the JAX package's
``ArrowFileReader`` on the CPU: the cases of tests/test_formats.py's
Arrow tests — footer blocks and schema, columns bitwise, a record batch
larger than a staging buffer — plus files the port writes, read by
pyarrow and by the JAX reader, and the refusals (nulls, strings, body
compression)."""

import numpy as np
import pytest
import torch

from nvme_strom_tpu.formats.arrow import ArrowFileReader as JaxReader
from nvme_strom_tpu.formats.arrow import _parse_footer_blocks as jax_blocks
from nvme_strom_tpu_torch.formats.arrow import (ArrowFileReader,
                                                _parse_footer_blocks,
                                                write_arrow_file)

from _torch_sql_util import engine_pair

CPU = "cpu"


@pytest.fixture(scope="module")
def engines():
    e, je = engine_pair(pool_bytes=32 << 20)
    with e, je:
        yield e, je


def _write_pyarrow(path, cols, batch_rows, **opts):
    import pyarrow as pa
    tbl = pa.table(cols)
    with pa.OSFile(str(path), "wb") as f:
        with pa.ipc.new_file(f, tbl.schema,
                             options=pa.ipc.IpcWriteOptions(**opts)) as w:
            for b in tbl.to_batches(max_chunksize=batch_rows):
                w.write_batch(b)


def _cols(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(n).astype(np.float32),
            "b": rng.integers(0, 1 << 30, n, dtype=np.int64),
            "c": rng.integers(-5, 5, n).astype(np.int32),
            "d": rng.standard_normal(n),
            "e": rng.integers(0, 200, n).astype(np.uint8)}


@pytest.mark.parametrize("n,batch", [(3000, 1000), (5000, 1250),
                                     (400_000, 400_000), (777, 100)])
def test_reader_matches_pyarrow_and_jax(n, batch, tmp_path, engines):
    e, je = engines
    cols = _cols(n, n)
    path = tmp_path / "t.arrow"
    _write_pyarrow(path, cols, batch)
    r = ArrowFileReader(path)
    footer = path.read_bytes()
    flen = int.from_bytes(footer[-10:-6], "little")
    fb = footer[-10 - flen:-10]
    assert _parse_footer_blocks(fb) == jax_blocks(fb)
    assert r.num_batches == -(-n // batch)
    assert r.names == list(cols)
    assert r.num_rows == n
    got = r.read_columns_to_device(e, device=CPU)
    for k, a in cols.items():
        assert got[k].dtype == torch.from_numpy(a).dtype
        assert np.array_equal(got[k].numpy(), a), k
    jgot = JaxReader(path).read_columns_to_device(je, columns=["a", "c"])
    for k in ("a", "c"):
        assert np.array_equal(np.asarray(jgot[k]), got[k].numpy())
    sub = r.read_columns_to_device(e, columns=["c"], device=CPU)
    assert list(sub) == ["c"]


@pytest.mark.parametrize("batch_rows", [None, 999, 4096])
def test_writer_read_by_pyarrow_and_jax(batch_rows, tmp_path, engines):
    import pyarrow as pa
    e, je = engines
    cols = _cols(10_001, 3)
    path = tmp_path / "w.arrow"
    write_arrow_file(path, cols, batch_rows=batch_rows)
    with pa.OSFile(str(path)) as f:
        rd = pa.ipc.open_file(f)
        tbl = rd.read_all()
        assert rd.num_record_batches == (
            1 if batch_rows is None else -(-10_001 // batch_rows))
    for k, a in cols.items():
        assert np.array_equal(tbl.column(k).to_numpy(), a), k
    jgot = JaxReader(path).read_columns_to_device(je, columns=["a", "c"])
    assert np.array_equal(np.asarray(jgot["a"]), cols["a"])
    assert np.array_equal(np.asarray(jgot["c"]), cols["c"])
    got = ArrowFileReader(path).read_columns_to_device(e, device=CPU)
    for k, a in cols.items():
        assert np.array_equal(got[k].numpy(), a), k


def test_refusals(tmp_path):
    import pyarrow as pa
    p = tmp_path / "n.arrow"
    _write_pyarrow(p, {"x": pa.array([1.0, None, 3.0], pa.float32())}, 3)
    with pytest.raises(ValueError, match="nulls"):
        ArrowFileReader(p)
    p = tmp_path / "s.arrow"
    _write_pyarrow(p, {"s": pa.array(["a", "b"])}, 2)
    with pytest.raises(ValueError, match="Utf8"):
        ArrowFileReader(p)
    p = tmp_path / "z.arrow"
    _write_pyarrow(p, {"x": np.arange(1000, dtype=np.int32)}, 1000,
                   compression="zstd")
    with pytest.raises(ValueError, match="compression"):
        ArrowFileReader(p)
    p = tmp_path / "bad.arrow"
    p.write_bytes(b"NOTARROW" + bytes(32))
    with pytest.raises(ValueError, match="not an Arrow"):
        ArrowFileReader(p)
    with pytest.raises(TypeError, match="integer and float"):
        write_arrow_file(tmp_path / "o.arrow",
                         {"s": np.array(["a"], object)})
