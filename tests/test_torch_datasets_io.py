"""The port's data side against the JAX package's: the shard export path
(``datasets/export.py``) through both readers, the native helpers
(``native/``), and the fetchers (``datasets/mnist.py``, ``fetchers.py``).

A shard file is plain ``.npz``: what either package writes, the other
reads back bit for bit, through numpy's reader and through the C++ mmap
reader, bfloat16 members included (the reference writes an
``ml_dtypes.bfloat16`` array, the port a ``torch.bfloat16`` tensor; both
land as the raw 2-byte void ``|V2``; the C++ reader gives the reference a
bfloat16 array and the port a bfloat16 tensor, numpy's reader ``|V2`` to
both). The native threshold codec equals the port's
``ops/compression.py`` codec bitwise. The readers and generators are numpy
in both packages: the same files and seeds give identical arrays. Every
MNIST test writes the four IDX files first, so no download is tried.
"""
import gzip
import io
import json
import os
import pickle
import struct
import tarfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import dataset as jdataset
from deeplearning4j_tpu.datasets import export as jexport
from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.datasets import dataset as tdataset
from deeplearning4j_tpu_torch.datasets import export as texport
from deeplearning4j_tpu_torch.datasets import fetchers as tfetchers
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.ops.compression import (threshold_decode,
                                                      threshold_encode)
from deeplearning4j_tpu_torch.ops.compression import ThresholdPayload


@pytest.fixture(autouse=True)
def _native_built():
    """The C++ helpers are part of this slice: on a host with g++ (this
    one) both must build in both packages. The reference builds in place
    and remembers a failed load for the process, so a load that raced
    another test process's build of the same library is tried again once
    that build has had time to end."""
    assert tnative.available() and tnative.shard_reader_available()
    for _ in range(20):
        if jnative.available() and jnative.shard_reader_available():
            return
        jnative._TRIED = jnative._SR_TRIED = False
        time.sleep(0.5)
    raise AssertionError("the reference's native helpers did not load")


def _bits(a):
    """A member as raw bytes (bf16 arrays, tensors and voids alike)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().tobytes() \
            if a.dtype == torch.bfloat16 else a.numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _batches(side, n=5, seed=3):
    """DataSets with float32 features, one-hot labels, a features mask,
    a multi-input list with a None hole, and bfloat16 features: written
    as each package holds them (``side`` "ref": ml_dtypes arrays, "port":
    torch tensors)."""
    r = np.random.default_rng(seed)
    pkg = jdataset if side == "ref" else tdataset
    out = []
    for i in range(n):
        x = r.normal(size=(8, 6, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)]
        m = (r.random((8, 6)) > 0.3).astype(np.float32)
        b = r.normal(size=(8, 5)).astype(np.float32)
        bf = (np.asarray(jnp.asarray(b, jnp.bfloat16)) if side == "ref"
              else torch.from_numpy(b).to(torch.bfloat16))
        if i % 2:
            out.append(pkg.DataSet([x, None, bf], y, m, None))
        else:
            out.append(pkg.DataSet(bf, y, None, m[:, :1]))
    return out


def _members(ds):
    parts = []
    for v in (ds.features, ds.labels, ds.features_mask, ds.labels_mask):
        if isinstance(v, list):
            parts.append([None if u is None else _bits(u) for u in v])
        else:
            parts.append(None if v is None else _bits(v))
    return parts


READERS = {
    "ref_numpy": jexport.ShardedFileDataSetIterator,
    "ref_native": jexport.NativeShardedFileDataSetIterator,
    "port_numpy": texport.ShardedFileDataSetIterator,
    "port_native": texport.NativeShardedFileDataSetIterator,
}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_shards_cross_read_bitwise(tmp_path, writer):
    """A shard written by either package reads back bit for bit through
    all four readers, and both packages write the same manifest."""
    src = _batches(writer)
    exp = jexport if writer == "ref" else texport
    d = str(tmp_path / "shards")
    manifest = exp.export_dataset_iterator(iter(src), d, batches_per_shard=2)
    other = (texport if writer == "ref" else jexport).export_dataset_iterator(
        iter(_batches("port" if writer == "ref" else "ref")),
        str(tmp_path / "other"), batches_per_shard=2)
    assert manifest == other
    assert json.load(open(os.path.join(d, "manifest.json"))) == manifest
    want = [_members(ds) for ds in src]
    for name, reader in READERS.items():
        got = [_members(ds) for ds in reader(d, reader_threads=2)]
        assert got == want, name
    port_native = list(texport.NativeShardedFileDataSetIterator(d))
    assert port_native[0].features.dtype == torch.bfloat16
    assert list(texport.ShardedFileDataSetIterator(d))[0] \
        .features.dtype.kind == "V"


def test_native_npz_members_equal_numpy_and_the_reference(tmp_path):
    """Every member of a mixed-dtype npz: the same names, shapes and bytes
    from the port's C++ reader, numpy, and the reference's C++ reader."""
    r = np.random.default_rng(4)
    path = str(tmp_path / "mixed.npz")
    arrs = {"u8": r.integers(0, 255, (4, 5)).astype(np.uint8),
            "i32": r.integers(-9, 9, (7,)).astype(np.int32),
            "i64": r.integers(-9, 9, (2, 2, 2)).astype(np.int64),
            "f32": r.normal(size=(3, 3)).astype(np.float32),
            "f64": r.normal(size=(6,)),
            "f32_fortran": np.asfortranarray(r.normal(size=(3, 4))
                                             .astype(np.float32)),
            "bf16": np.asarray(jnp.asarray([1.5, -2.25, 0.125], jnp.bfloat16)),
            "scalar": np.asarray(3.25, np.float32)}
    np.savez(path, **arrs)
    with np.load(path) as zn, tnative.NativeNpzFile(path) as zt, \
            jnative.NativeNpzFile(path) as zj:
        assert zt.files == zj.files and sorted(zt.files) == sorted(zn.files)
        for name in zn.files:
            a, b, c = zn[name], zt[name], zj[name]
            assert tuple(b.shape) == a.shape == c.shape, name
            assert _bits(b) == _bits(a) == _bits(c), name
            if name == "bf16":
                assert b.dtype == torch.bfloat16
            else:
                assert b.dtype == a.dtype and b.flags.f_contiguous == \
                    a.flags.f_contiguous, name


def test_native_reader_refuses_what_it_cannot_type(tmp_path):
    weird = str(tmp_path / "weird.npz")
    np.savez(weird, arr=np.zeros(4, dtype="V4"))
    with tnative.NativeNpzFile(weird) as z:
        with pytest.raises(ValueError, match="void dtype"):
            z["arr"]
    packed = str(tmp_path / "c.npz")
    np.savez_compressed(packed, x=np.arange(10.0))
    with pytest.raises(OSError):
        tnative.NativeNpzFile(packed)


def test_iterators_and_entry_point(tmp_path, monkeypatch):
    """``make_shard_iterator`` takes the native reader when it built, and
    numpy's otherwise (as the reference's); ``for_process`` without a
    process group is one worker; partitions and validation as the
    reference's."""
    d = str(tmp_path / "s")
    texport.export_dataset_iterator(iter(_batches("port", n=6)), d,
                                    batches_per_shard=2)
    it = texport.make_shard_iterator(d)
    assert type(it) is texport.NativeShardedFileDataSetIterator
    assert type(texport.make_shard_iterator(d, prefer_native=False)) is \
        texport.ShardedFileDataSetIterator
    whole = texport.ShardedFileDataSetIterator.for_process(d)
    assert (whole.shard_index, whole.num_shards) == (0, 1)
    assert len(list(whole)) == 6
    parts = [texport.ShardedFileDataSetIterator(d, shard_index=k,
                                                num_shards=3)
             for k in range(3)]
    ref_parts = [jexport.ShardedFileDataSetIterator(d, shard_index=k,
                                                    num_shards=3)
                 for k in range(3)]
    assert [p._files for p in parts] == [p._files for p in ref_parts]
    shuffled = texport.ShardedFileDataSetIterator(d, shuffle_shards=True,
                                                  seed=5)
    ref_shuffled = jexport.ShardedFileDataSetIterator(d, shuffle_shards=True,
                                                      seed=5)
    assert [_members(b) for b in shuffled] == \
        [_members(b) for b in ref_shuffled]
    with pytest.raises(ValueError):
        texport.ShardedFileDataSetIterator(d, shard_index=3, num_shards=3)
    with pytest.raises(ValueError, match="gets no shards"):
        texport.ShardedFileDataSetIterator(d, shard_index=4, num_shards=5)
    with pytest.raises(FileNotFoundError):
        texport.ShardedFileDataSetIterator(str(tmp_path))
    monkeypatch.setattr(tnative, "shard_reader_available", lambda: False)
    assert type(texport.make_shard_iterator(d)) is \
        texport.ShardedFileDataSetIterator


# --------------------------------------------------------- threshold codec
@pytest.mark.parametrize("n,threshold,capacity", [
    (10_000, 0.5, 10_000), (10_000, 0.5, 700), (65_536 + 777, 1.0, 4096),
    (1000, 0.0, 1000)])
def test_native_codec_equals_threshold_encode(n, threshold, capacity):
    r = np.random.default_rng(n + capacity)
    res = r.normal(size=n).astype(np.float32)
    res[::97] = 0.0
    res[5] = threshold                    # on the threshold: sent
    idx, signs, count, new_res = tnative.native_threshold_encode(
        res, threshold, capacity)
    payload, want_res = threshold_encode(torch.from_numpy(res), threshold,
                                         capacity)
    np.testing.assert_array_equal(idx, payload.indices.numpy())
    np.testing.assert_array_equal(signs, payload.signs.numpy())
    assert count == int(payload.count)
    np.testing.assert_array_equal(new_res, want_res.numpy())
    ref = jnative.native_threshold_encode(res, threshold, capacity)
    for a, b in zip((idx, signs, count, new_res), ref):
        np.testing.assert_array_equal(a, b)
    dec = tnative.native_threshold_decode(idx, signs, threshold, n)
    want = threshold_decode(ThresholdPayload(payload.indices, payload.signs,
                                             payload.count), threshold, n)
    np.testing.assert_array_equal(dec, want.numpy())


def test_native_libraries_are_named_by_their_source():
    for src in ("threshold_codec.cpp", "shard_reader.cpp"):
        path = tnative.library_path(src)
        assert os.path.exists(path)
        with open(os.path.join(os.path.dirname(tnative.__file__), src),
                  "rb") as f, open(os.path.join(
                      os.path.dirname(jnative.__file__), src), "rb") as g:
            assert f.read() == g.read()        # byte for byte


# ---------------------------------------------------------------- fetchers
def _write_idx(cache, tx, ty, vx, vy):
    for name, arr in (("train_images", tx), ("train_labels", ty),
                      ("test_images", vx), ("test_labels", vy)):
        head = (struct.pack(">IIII", 2051, *arr.shape) if arr.ndim == 3
                else struct.pack(">II", 2049, arr.shape[0]))
        with gzip.open(os.path.join(cache, name + ".gz"), "wb") as f:
            f.write(head + arr.astype(np.uint8).tobytes())


def test_synthetic_mnist_equals_the_reference():
    got = tmnist._synthetic_mnist(96, 32, seed=7)
    want = jmnist._synthetic_mnist(96, 32, seed=7)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_mnist_reads_idx_files_as_the_reference(tmp_path):
    cache = str(tmp_path)
    _write_idx(cache, *tmnist._synthetic_mnist(200, 50, seed=3))
    got, want = tmnist.load_mnist(cache), jmnist.load_mnist(cache)
    assert got[4] is False and want[4] is False
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    for flat in (False, True):
        kw = dict(train=False, flat=flat, seed=2, max_examples=40,
                  cache_dir=cache)
        it_t = tmnist.MnistDataSetIterator(16, **kw)
        it_j = jmnist.MnistDataSetIterator(16, **kw)
        assert not it_t.synthetic
        for a, b in zip(it_t, it_j):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)
    bad = os.path.join(cache, "train_labels.gz")
    with gzip.open(bad, "wb") as f:
        f.write(struct.pack(">II", 2051, 0))
    with pytest.raises(AssertionError, match="magic"):
        tmnist._read_idx_labels(bad)


def test_iris_curves_and_synthetic_sets_equal_the_reference(tmp_path):
    for shuffle in (True, False):
        for a, b in zip(tfetchers.load_iris(shuffle=shuffle, seed=4),
                        jfetchers.load_iris(shuffle=shuffle, seed=4)):
            assert np.array_equal(a, b)
    it_t = tfetchers.IrisDataSetIterator(batch_size=40, num_examples=100)
    it_j = jfetchers.IrisDataSetIterator(batch_size=40, num_examples=100)
    for a, b in zip(it_t, it_j):
        assert np.array_equal(a.features, b.features)
    for a, b in zip(tfetchers.load_curves(12, 20, seed=3),
                    jfetchers.load_curves(12, 20, seed=3)):
        assert np.array_equal(a, b)
    for train in (True, False):
        got = tfetchers.load_cifar10(str(tmp_path), train, n_synthetic=64)
        want = jfetchers.load_cifar10(str(tmp_path), train, n_synthetic=64)
        assert got[2] is want[2] is True
        assert np.array_equal(got[0], want[0]) and \
            np.array_equal(got[1], want[1])
    got = tfetchers.load_lfw(str(tmp_path), height=16, width=12,
                             n_synthetic=20)
    want = jfetchers.load_lfw(str(tmp_path), height=16, width=12,
                              n_synthetic=20)
    assert got[2:] == want[2:]
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(FileNotFoundError):
        tfetchers.load_cifar10(str(tmp_path), allow_synthetic_fallback=False)


def test_cifar_pickle_tarball_reads_as_the_reference(tmp_path):
    """A ``cifar-10-python.tar.gz`` made here: five training batches and
    a test batch of the standard pickles."""
    r = np.random.default_rng(11)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for nm in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            d = {b"data": r.integers(0, 256, (6, 3072)).astype(np.uint8),
                 b"labels": [int(v) for v in r.integers(0, 10, 6)]}
            raw = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{nm}")
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    for side in ("port", "ref"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "cifar-10-python.tar.gz").write_bytes(
            buf.getvalue())
    for train in (True, False):
        got = tfetchers.load_cifar10(str(tmp_path / "port"), train)
        want = jfetchers.load_cifar10(str(tmp_path / "ref"), train)
        assert got[2] is want[2] is False
        assert got[0].shape == ((30 if train else 6), 32, 32, 3)
        assert np.array_equal(got[0], want[0]) and \
            np.array_equal(got[1], want[1])
    it = tfetchers.Cifar10DataSetIterator(4, cache_dir=str(tmp_path / "port"),
                                          num_examples=10)
    assert not it.synthetic and [len(b.features) for b in it] == [4, 4, 2]


def test_lfw_reads_person_directories_as_the_reference(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    for name, k in {"Alice_A": 3, "Bob_B": 2, "Carol_C": 1}.items():
        d = tmp_path / "lfw" / name
        d.mkdir(parents=True)
        for i in range(k):
            Image.fromarray((rng.random((40, 30, 3)) * 255).astype(np.uint8)) \
                .save(str(d / f"{name}_{i:04d}.jpg"))
    got = tfetchers.load_lfw(str(tmp_path), height=24, width=24)
    want = jfetchers.load_lfw(str(tmp_path), height=24, width=24)
    assert got[2] == want[2] == ["Alice_A", "Bob_B"] and got[3] is False
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
