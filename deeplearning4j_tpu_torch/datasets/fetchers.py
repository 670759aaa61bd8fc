"""Dataset fetchers: Iris, CIFAR-10, Curves.

A copy of ``deeplearning4j_tpu/datasets/fetchers.py`` (numpy only; PIL,
imported lazily, for LFW): the same readers and the same synthetic sets
from the same seeds, bit for bit, over the port's ``ListDataSetIterator``
and its own copy of ``iris.dat``.

Reference: datasets/fetchers/{IrisDataFetcher, CurvesDataFetcher}.java,
datasets/iterator/impl/{IrisDataSetIterator, CifarDataSetIterator}.java and
base/IrisUtils.java. Iris ships in-package (iris.dat — Fisher's public-domain
measurements, the same resource the reference bundles). CIFAR-10 reads the
standard python-pickle batches from a local cache dir (nothing is
downloaded; a deterministic synthetic fallback keeps tests/demos
running, mirroring datasets/mnist.py's stance). Curves is the synthetic
curves regression set, generated deterministically.
"""
from __future__ import annotations

import os
import pickle
import tarfile
from typing import Optional, Tuple

import numpy as np

from .dataset import ListDataSetIterator

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CACHE = os.path.expanduser("~/.deeplearning4j_tpu/datasets")


# ----------------------------------------------------------------------- Iris
def load_iris(shuffle: bool = True, seed: int = 12345
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(features [150,4] float32, one-hot labels [150,3]) — reference
    IrisDataFetcher.fetch + IrisUtils.loadIris."""
    rows = np.loadtxt(os.path.join(_HERE, "iris.dat"), delimiter=",",
                      dtype=np.float32)
    x, yi = rows[:, :4], rows[:, 4].astype(np.int64)
    if shuffle:
        order = np.random.default_rng(seed).permutation(len(x))
        x, yi = x[order], yi[order]
    y = np.eye(3, dtype=np.float32)[yi]
    return x, y


class IrisDataSetIterator(ListDataSetIterator):
    """Reference datasets/iterator/impl/IrisDataSetIterator.java."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 shuffle: bool = True, seed: int = 12345):
        x, y = load_iris(shuffle=shuffle, seed=seed)
        super().__init__(features=x[:num_examples], labels=y[:num_examples],
                         batch_size=batch_size)


# --------------------------------------------------------------------- CIFAR10
def _synthetic_cifar(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent colored blobs: learnable, deterministic, clearly
    labeled synthetic (same stance as datasets/mnist.py:_synthetic_mnist)."""
    rng = np.random.default_rng(seed)
    yi = rng.integers(0, 10, n)
    x = rng.normal(0.45, 0.2, size=(n, 32, 32, 3)).astype(np.float32)
    for c in range(10):
        mask = yi == c
        # class-specific mean color + quadrant brightening
        x[mask, :, :, c % 3] += 0.25
        qh, qw = (c // 3) % 2, (c // 6) % 2
        x[mask, qh * 16:(qh + 1) * 16, qw * 16:(qw + 1) * 16, :] += 0.15
    np.clip(x, 0.0, 1.0, out=x)
    return x, np.eye(10, dtype=np.float32)[yi]


def load_cifar10(cache_dir: str = DEFAULT_CACHE, train: bool = True,
                 allow_synthetic_fallback: bool = True,
                 n_synthetic: int = 2048
                 ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """NHWC [N,32,32,3] float32 in [0,1] + one-hot labels + ``synthetic``
    flag. Looks for the standard ``cifar-10-batches-py`` pickles (or the
    .tar.gz) under ``cache_dir`` (reference CifarDataSetIterator is
    DataVec-backed; binary parsing is the capability mirrored here)."""
    root = os.path.join(cache_dir, "cifar-10-batches-py")
    tgz = os.path.join(cache_dir, "cifar-10-python.tar.gz")
    if not os.path.isdir(root) and os.path.exists(tgz):
        with tarfile.open(tgz, "r:gz") as tf:
            tf.extractall(cache_dir, filter="data")  # refuse path traversal
    if os.path.isdir(root):
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        xs, ys = [], []
        for nm in names:
            with open(os.path.join(root, nm), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.append(np.asarray(d[b"labels"], np.int64))
        x = (np.concatenate(xs).reshape(-1, 3, 32, 32)
             .transpose(0, 2, 3, 1).astype(np.float32) / 255.0)
        y = np.eye(10, dtype=np.float32)[np.concatenate(ys)]
        return x, y, False
    if not allow_synthetic_fallback:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {cache_dir!r} and downloads are "
            f"unavailable; place cifar-10-python.tar.gz there")
    x, y = _synthetic_cifar(n_synthetic, seed=7 if train else 11)
    return x, y, True


class Cifar10DataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int = 128, *, train: bool = True,
                 cache_dir: str = DEFAULT_CACHE, num_examples: Optional[int] = None,
                 allow_synthetic_fallback: bool = True):
        x, y, self.synthetic = load_cifar10(cache_dir, train,
                                            allow_synthetic_fallback)
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(features=x, labels=y, batch_size=batch_size)


# ---------------------------------------------------------------------- Curves
def load_curves(n: int = 1024, resolution: int = 28, seed: int = 12345
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic curves for unsupervised pretraining (reference
    CurvesDataFetcher downloads curves.ser — parametric 2-D curves rendered
    to 28x28 images; features == labels, an autoencoder dataset). Generated
    deterministically: random cubic Bezier curves rasterized with gaussian
    pen strokes."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, 64)[:, None]
    grid = np.linspace(0.0, 1.0, resolution)
    out = np.zeros((n, resolution, resolution), np.float32)
    for i in range(n):
        p = rng.random((4, 2))    # control points in [0,1]^2
        curve = ((1 - t) ** 3 * p[0] + 3 * (1 - t) ** 2 * t * p[1]
                 + 3 * (1 - t) * t ** 2 * p[2] + t ** 3 * p[3])  # [64,2]
        dx = grid[None, :] - curve[:, 0:1]
        dy = grid[None, :] - curve[:, 1:2]
        img = np.exp(-(dx[:, None, :] ** 2 + dy[:, :, None] ** 2) / (2 * 0.03 ** 2))
        out[i] = img.max(axis=0)
    flat = out.reshape(n, -1)
    return flat, flat.copy()     # features == labels (reconstruction target)


class CurvesDataSetIterator(ListDataSetIterator):
    def __init__(self, batch_size: int = 128, num_examples: int = 1024,
                 resolution: int = 28, seed: int = 12345):
        x, y = load_curves(num_examples, resolution, seed)
        super().__init__(features=x, labels=y, batch_size=batch_size)


# ------------------------------------------------------------------------ LFW
def _synthetic_lfw(n: int, n_people: int, h: int, w: int, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-person base 'face' + per-image noise: identity-learnable,
    deterministic, clearly synthetic (same stance as _synthetic_cifar)."""
    rng = np.random.default_rng(seed)
    yi = rng.integers(0, n_people, n)
    base = rng.normal(0.5, 0.18, size=(n_people, h, w, 3))
    x = base[yi] + rng.normal(0.0, 0.06, size=(n, h, w, 3))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return x, np.eye(n_people, dtype=np.float32)[yi]


def load_lfw(cache_dir: str = DEFAULT_CACHE, *, height: int = 64,
             width: int = 64, num_people: Optional[int] = None,
             min_images_per_person: int = 2,
             allow_synthetic_fallback: bool = True, n_synthetic: int = 256,
             n_synthetic_people: int = 5
             ) -> Tuple[np.ndarray, np.ndarray, list, bool]:
    """Labeled Faces in the Wild (reference
    datasets/fetchers/LFWDataFetcher.java: downloads+untars the lfw archive
    of person-named jpg directories, labels = person identities, images
    scaled to the requested dims).

    Looks for the standard ``lfw/<person_name>/*.jpg`` tree (or ``lfw.tgz``)
    under ``cache_dir`` — nothing is downloaded, so the
    archive must be pre-placed; otherwise a deterministic synthetic fallback
    keeps demos/tests running. Returns (x [N,h,w,3] float32 in [0,1],
    one-hot labels, person_names, synthetic_flag). People are filtered to
    those with >= ``min_images_per_person`` images (the reference's subset
    behavior) and truncated to ``num_people`` most-photographed identities.
    """
    root = os.path.join(cache_dir, "lfw")
    tgz = os.path.join(cache_dir, "lfw.tgz")
    if not os.path.isdir(root) and os.path.exists(tgz):
        with tarfile.open(tgz, "r:gz") as tf:
            tf.extractall(cache_dir, filter="data")  # refuse path traversal
    if os.path.isdir(root):
        from PIL import Image
        people = []
        for name in sorted(os.listdir(root)):
            pdir = os.path.join(root, name)
            if not os.path.isdir(pdir):
                continue
            files = sorted(f for f in os.listdir(pdir)
                           if f.lower().endswith((".jpg", ".jpeg", ".png")))
            if len(files) >= min_images_per_person:
                people.append((name, pdir, files))
        people.sort(key=lambda t: -len(t[2]))
        if num_people:
            people = people[:num_people]
        people.sort(key=lambda t: t[0])
        if not people:
            raise FileNotFoundError(
                f"LFW tree at {root!r} has no identity with >= "
                f"{min_images_per_person} images "
                f"(min_images_per_person filter) — lower the threshold or "
                f"check the directory layout (lfw/<person_name>/*.jpg)")
        xs, yi, names = [], [], []
        for label, (name, pdir, files) in enumerate(people):
            names.append(name)
            for f in files:
                img = Image.open(os.path.join(pdir, f)).convert("RGB")
                img = img.resize((width, height), Image.BILINEAR)
                xs.append(np.asarray(img, np.float32) / 255.0)
                yi.append(label)
        x = np.stack(xs)
        y = np.eye(len(people), dtype=np.float32)[np.asarray(yi)]
        return x, y, names, False
    if not allow_synthetic_fallback:
        raise FileNotFoundError(
            f"LFW not found under {cache_dir!r} and downloads are "
            f"unavailable; place lfw.tgz there")
    x, y = _synthetic_lfw(n_synthetic, n_synthetic_people, height, width,
                          seed=23)
    return x, y, [f"person_{i}" for i in range(n_synthetic_people)], True


class LFWDataSetIterator(ListDataSetIterator):
    """Reference datasets/iterator/impl/LFWDataSetIterator.java."""

    def __init__(self, batch_size: int = 32, *, height: int = 64,
                 width: int = 64, num_people: Optional[int] = None,
                 num_examples: Optional[int] = None,
                 cache_dir: str = DEFAULT_CACHE,
                 allow_synthetic_fallback: bool = True, shuffle: bool = True,
                 seed: int = 12345):
        x, y, self.people, self.synthetic = load_lfw(
            cache_dir, height=height, width=width, num_people=num_people,
            allow_synthetic_fallback=allow_synthetic_fallback)
        if shuffle:
            order = np.random.default_rng(seed).permutation(len(x))
            x, y = x[order], y[order]
        if num_examples:
            x, y = x[:num_examples], y[:num_examples]
        super().__init__(features=x, labels=y, batch_size=batch_size)
