"""Port parity: ``quattro_tpu_torch.io`` (shard IO) against ``quattro_tpu.io``.

The file format is the same bit for bit: shards written by either package,
on either backend (the native C++ library or the pure-Python framing), read
back in the other. ``tests/test_io.py``'s cases run on the port's module as
cases parametrized over the backend.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from quattro_tpu.io import shardio as jshardio
from quattro_tpu_torch.io import shardio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["native", "python"]


def _use(module, backend, monkeypatch):
    """Pin ``module``'s backend for one test (the native library is loaded once per process)."""
    if backend == "native":
        if module._load_native() is None:
            pytest.skip("no C++ compiler: the native shard IO library cannot be built")
    else:
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_lib_tried", True)


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    _use(shardio, request.param, monkeypatch)
    return request.param


def _sample_records(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {
            "x_seq": rng.normal(size=(31, 4)),
            "kk": rng.normal(size=(30, 5)).astype(np.float32),
            "iteration": np.int64(i),
            "cost": np.float64(rng.normal()),
        }
        for i in range(n)
    ]


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype


def _write(module, path, records):
    with module.ShardWriter(path) as w:
        for r in records:
            w.append(r)


@pytest.mark.parametrize("encoder", ["port", "jax"])
def test_payload_roundtrip_across_packages(encoder):
    rec = {
        "f64": np.arange(6, dtype=np.float64).reshape(2, 3),
        "f32": np.float32(3.5),
        "i32": np.arange(4, dtype=np.int32),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 7)),
        "scalar0d": np.array(2.0),
    }
    enc, dec = (shardio, jshardio) if encoder == "port" else (jshardio, shardio)
    payload = enc.encode_payload(rec)
    assert payload == dec.encode_payload(rec)  # the same bytes
    _assert_records_equal([dec.decode_payload(memoryview(payload))], [rec])


@pytest.mark.parametrize("reader_backend", BACKENDS)
@pytest.mark.parametrize("writer_backend", BACKENDS)
@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_shards_cross_packages_and_backends(tmp_path, monkeypatch, writer, reader, writer_backend, reader_backend):
    """A shard written by one package and backend reads back in the other, and the files are equal bytes."""
    modules = {"port": shardio, "jax": jshardio}
    records = _sample_records()
    path = str(tmp_path / "logs.qtshard")
    with monkeypatch.context() as patch:
        _use(modules[writer], writer_backend, patch)
        _write(modules[writer], path, records[:3])
        _write(modules[writer], path, records[3:])  # reopen appends, no second magic
    with monkeypatch.context() as patch:
        _use(modules[reader], reader_backend, patch)
        _assert_records_equal(modules[reader].read_shard(path), records)
        with modules[reader].ShardReader(path) as r:
            assert len(r) == len(records)
            np.testing.assert_array_equal(r[2]["x_seq"], records[2]["x_seq"])
    other = str(tmp_path / "other.qtshard")
    _write(jshardio if writer == "port" else shardio, other, records[:3])
    _write(jshardio if writer == "port" else shardio, other, records[3:])
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_writer_reader_roundtrip(tmp_path, backend):
    path = str(tmp_path / "logs.qtshard")
    records = _sample_records()
    _write(shardio, path, records)
    _assert_records_equal(shardio.read_shard(path), records)
    with shardio.ShardReader(path) as r:
        assert len(r) == len(records)
        np.testing.assert_array_equal(r[2]["x_seq"], records[2]["x_seq"])


def test_append_reopen(tmp_path, backend):
    path = str(tmp_path / "logs.qtshard")
    recs = _sample_records(4)
    _write(shardio, path, recs[:2])
    _write(shardio, path, recs[2:])
    _assert_records_equal(shardio.read_shard(path), recs)


def test_corrupt_tail_truncates_not_raises(tmp_path, backend):
    """Crash-bounded loss: corruption invalidates only the tail records."""
    path = str(tmp_path / "logs.qtshard")
    recs = _sample_records(3)
    _write(shardio, path, recs)
    offsets, _ = shardio.index_shard(path)
    assert len(offsets) == 3
    with open(path, "r+b") as f:
        f.seek(offsets[1] + 3)
        b = f.read(1)
        f.seek(offsets[1] + 3)
        f.write(bytes([b[0] ^ 0xFF]))
    _assert_records_equal(shardio.read_shard(path), recs[:1])
    with open(path, "r+b") as f:
        f.truncate(offsets[1] + 4)
    _assert_records_equal(shardio.read_shard(path), recs[:1])


def test_bad_magic_raises(tmp_path, backend):
    path = str(tmp_path / "bad.qtshard")
    with open(path, "wb") as f:
        f.write(b"NOTASHRD" + b"\x00" * 64)
    with pytest.raises(ValueError):
        shardio.index_shard(path)


def test_corrupt_huge_length_is_truncation_not_crash(tmp_path, backend):
    path = str(tmp_path / "hugelen.qtshard")
    recs = _sample_records(3)
    _write(shardio, path, recs)
    offsets, _ = shardio.index_shard(path)
    with open(path, "r+b") as f:
        f.seek(offsets[1] - 12)  # header = magic(4) + len(8) + crc(4)
        f.write(struct.pack("<Q", 0xFFFFFFFFFFFFFFF0))
    _assert_records_equal(shardio.read_shard(path), recs[:1])


def test_append_behind_foreign_file_refused(tmp_path, backend):
    path = str(tmp_path / "foreign.bin")
    with open(path, "wb") as f:
        f.write(b"NOTASHRD-some-other-format")
    with pytest.raises(ValueError, match="refusing to append"):
        shardio.ShardWriter(path)
    src = str(tmp_path / "src.qtshard")
    _write(shardio, src, _sample_records(2))
    with pytest.raises(ValueError, match="refusing to append"):
        shardio.merge_shards(path, [src])
    with open(path, "rb") as f:
        assert f.read() == b"NOTASHRD-some-other-format"


def test_missing_file_raises_filenotfound(tmp_path, backend):
    with pytest.raises(FileNotFoundError):
        shardio.index_shard(str(tmp_path / "nope.qtshard"))


def test_merge_onto_self_raises(tmp_path, backend):
    p = str(tmp_path / "self.qtshard")
    _write(shardio, p, _sample_records(2))
    with pytest.raises(ValueError):
        shardio.merge_shards(p, [p])
    assert len(shardio.read_shard(p)) == 2


@pytest.mark.parametrize("source_writer", ["port", "jax"])
def test_merge_shards(tmp_path, backend, source_writer):
    srcs, all_recs = [], []
    for i in range(3):
        p = str(tmp_path / f"part{i}.qtshard")
        recs = _sample_records(2, seed=i)
        _write(shardio if source_writer == "port" else jshardio, p, recs)
        srcs.append(p)
        all_recs.extend(recs)
    srcs.insert(1, str(tmp_path / "missing.qtshard"))  # skipped
    dst = str(tmp_path / "combined.qtshard")
    assert shardio.merge_shards(dst, srcs) == 6
    _assert_records_equal(shardio.read_shard(dst), all_recs)
    _assert_records_equal(jshardio.read_shard(dst), all_recs)
    with pytest.raises(FileNotFoundError):
        shardio.merge_shards(dst, [str(tmp_path / "missing.qtshard")], missing_ok=False)


def test_pure_python_environment_variable(tmp_path):
    """The port's environment variable selects the pure-Python framing in a fresh process; its shard reads here."""
    path = str(tmp_path / "py.qtshard")
    recs = _sample_records(3, seed=7)
    code = (
        "import os, sys, numpy as np\n"
        f"os.environ[{shardio.PURE_PYTHON_ENV!r}] = '1'\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from quattro_tpu_torch.io.shardio import ShardWriter, native_available\n"
        "assert not native_available()\n"
        "rng = np.random.default_rng(7)\n"
        f"with ShardWriter({path!r}) as w:\n"
        "    for i in range(3):\n"
        "        w.append({'x_seq': rng.normal(size=(31, 4)),\n"
        "                  'kk': rng.normal(size=(30, 5)).astype(np.float32),\n"
        "                  'iteration': np.int64(i),\n"
        "                  'cost': np.float64(rng.normal())})\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, capture_output=True)
    _assert_records_equal(shardio.read_shard(path), recs)
    _assert_records_equal(jshardio.read_shard(path), recs)


def test_native_backend_is_built_in_the_port():
    """Where g++ exists the port builds its own library, into quattro_tpu_torch/_build/shardio/."""
    if shardio._load_native() is None:
        pytest.skip("no C++ compiler: the native shard IO library cannot be built")
    assert shardio.native_available()
    assert os.path.exists(os.path.join(ROOT, "quattro_tpu_torch", "_build", "shardio", "libqtshardio.so"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gain_dataset_roundtrip_shard_and_npz(tmp_path, writer):
    """``save_gain_dataset``/``load_gain_dataset`` of either package read each other's shard and npz files."""
    from quattro_tpu import training as jtraining
    from quattro_tpu_torch import training

    rng = np.random.default_rng(3)
    ds = training.GainDataset(
        x_data=rng.normal(size=(10, 31, 4)).astype(np.float32),
        kk_data=rng.normal(size=(10, 30, 5)).astype(np.float32),
    )
    save, load = ((training.save_gain_dataset, jtraining.load_gain_dataset) if writer == "port"
                  else (jtraining.save_gain_dataset, training.load_gain_dataset))
    shard = str(tmp_path / "ds.qtshard")
    npz = str(tmp_path / "ds.npz")
    save(shard, ds, rows_per_record=4)  # 3 records: 4+4+2 rows
    save(npz, ds)
    back = load([shard, npz])
    np.testing.assert_array_equal(back.x_data[:10], ds.x_data)
    np.testing.assert_array_equal(back.x_data[10:], ds.x_data)
    np.testing.assert_array_equal(back.kk_data[:10], ds.kk_data)
    assert back.kk_data.shape[0] == 20
