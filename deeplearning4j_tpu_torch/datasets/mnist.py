"""MNIST dataset fetcher + iterator.

A copy of ``deeplearning4j_tpu/datasets/mnist.py`` (numpy only): the IDX
readers, the same synthetic set from the same seed (bit for bit) and the
same iterator, over the port's ``ListDataSetIterator``. A cache that
holds the four IDX files is read without a download.

Reference: deeplearning4j-core datasets/fetchers/MnistDataFetcher.java:65
(download + untar + idx readers in datasets/mnist/) and
MnistDataSetIterator. Behavior preserved: downloads the idx files into a
local cache dir on first use, then memory-maps them.

Where the download fails (no network) a deterministic SYNTHETIC
MNIST-like set is generated instead (class prototypes + noise + shifts) so
the full pipeline — fetch, normalize, batch, train, evaluate — still runs;
the flag ``synthetic`` on the returned arrays records which path produced
them.
"""
from __future__ import annotations

import gzip
import os
import struct
import urllib.request
from typing import Optional, Tuple

import numpy as np

from .dataset import ListDataSetIterator

MNIST_URLS = {
    "train_images": "https://storage.googleapis.com/cvdf-datasets/mnist/train-images-idx3-ubyte.gz",
    "train_labels": "https://storage.googleapis.com/cvdf-datasets/mnist/train-labels-idx1-ubyte.gz",
    "test_images": "https://storage.googleapis.com/cvdf-datasets/mnist/t10k-images-idx3-ubyte.gz",
    "test_labels": "https://storage.googleapis.com/cvdf-datasets/mnist/t10k-labels-idx1-ubyte.gz",
}

DEFAULT_CACHE = os.path.expanduser("~/.deeplearning4j_tpu/mnist")


def _read_idx_images(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad idx image magic {magic}"
        return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx label magic {magic}"
        return np.frombuffer(f.read(), np.uint8)


def _synthetic_mnist(n_train: int, n_test: int, seed: int = 12345):
    """Deterministic MNIST-shaped synthetic data: 10 smooth class prototypes,
    samples are shifted/noised copies. Learnable by LeNet to >95%."""
    rng = np.random.default_rng(seed)
    protos = []
    for c in range(10):
        base = np.zeros((28, 28), np.float32)
        crng = np.random.default_rng(1000 + c)
        for _ in range(4):  # a few random thick strokes per class
            r0, c0 = crng.integers(4, 24, 2)
            r1, c1 = crng.integers(4, 24, 2)
            steps = 20
            for t in np.linspace(0, 1, steps):
                rr, cc = int(r0 + t * (r1 - r0)), int(c0 + t * (c1 - c0))
                base[max(rr - 1, 0):rr + 2, max(cc - 1, 0):cc + 2] = 1.0
        protos.append(base)
    protos = np.stack(protos)

    def make(n, rng):
        labels = rng.integers(0, 10, n)
        imgs = np.zeros((n, 28, 28), np.float32)
        for i, c in enumerate(labels):
            img = protos[c]
            dy, dx = rng.integers(-3, 4, 2)
            img = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
            img = img + rng.normal(0, 0.25, (28, 28)).astype(np.float32)
            imgs[i] = np.clip(img, 0, 1)
        return (imgs * 255).astype(np.uint8), labels.astype(np.uint8)

    return make(n_train, rng) + make(n_test, rng)


def load_mnist(cache_dir: str = DEFAULT_CACHE, allow_synthetic_fallback: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """Returns (train_x, train_y, test_x, test_y, synthetic) with images uint8
    [N,28,28] and labels uint8 [N]."""
    os.makedirs(cache_dir, exist_ok=True)
    paths = {k: os.path.join(cache_dir, k + ".gz") for k in MNIST_URLS}
    try:
        for k, url in MNIST_URLS.items():
            if not os.path.exists(paths[k]):
                urllib.request.urlretrieve(url, paths[k])  # nosec - dataset fetch
        return (_read_idx_images(paths["train_images"]),
                _read_idx_labels(paths["train_labels"]),
                _read_idx_images(paths["test_images"]),
                _read_idx_labels(paths["test_labels"]), False)
    except Exception:
        if not allow_synthetic_fallback:
            raise
        tx, ty, vx, vy = _synthetic_mnist(8192, 2048)
        return tx, ty, vx, vy, True


class MnistDataSetIterator(ListDataSetIterator):
    """Batched MNIST (reference MnistDataSetIterator): features normalized to
    [0,1], labels one-hot[10]. ``flat=True`` yields [B,784] (MLP);
    flat=False yields NHWC [B,28,28,1] (LeNet)."""

    def __init__(self, batch_size: int, train: bool = True, *, flat: bool = False,
                 seed: int = 6, shuffle: bool = True, max_examples: Optional[int] = None,
                 cache_dir: str = DEFAULT_CACHE):
        tx, ty, vx, vy, self.synthetic = load_mnist(cache_dir)
        x, y = (tx, ty) if train else (vx, vy)
        if max_examples:
            x, y = x[:max_examples], y[:max_examples]
        feats = (x.astype(np.float32) / 255.0)
        feats = feats.reshape(len(x), -1) if flat else feats[..., None]
        labels = np.eye(10, dtype=np.float32)[y]
        super().__init__(features=feats, labels=labels, batch_size=batch_size,
                         shuffle=shuffle, seed=seed)
