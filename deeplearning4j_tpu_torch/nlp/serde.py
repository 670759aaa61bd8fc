"""Word-vector serialization.

Counterpart of ``deeplearning4j_tpu/nlp/serde.py``, copied unchanged: for
the same tables either package writes the same bytes, and each reads the
other's files. This is how vectors cross between the two packages.

Reference: models/embeddings/loader/WordVectorSerializer.java — text format
(word v1 v2 ...), Google News binary .bin format (read+write), zip model
format. Text and Google-binary supported here.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .sequence_vectors import SequenceVectors
from .vocab import VocabCache, VocabWord


def write_word_vectors(model: SequenceVectors, path: str):
    """Plain-text format (reference writeWordVectors)."""
    with open(path, "w", encoding="utf-8") as f:
        for i in range(len(model.vocab)):
            w = model.vocab.word_at(i)
            vec = " ".join(f"{v:.6f}" for v in model.syn0[i])
            f.write(f"{w} {vec}\n")


def read_word_vectors(path: str) -> SequenceVectors:
    """Reference loadTxtVectors."""
    words, vecs = [], []
    with open(path, encoding="utf-8") as f:
        first = f.readline().split()
        # optional "V D" header line
        if len(first) == 2 and first[0].isdigit() and first[1].isdigit():
            pass
        else:
            words.append(first[0])
            vecs.append([float(v) for v in first[1:]])
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            vecs.append([float(v) for v in parts[1:]])
    return _from_arrays(words, np.asarray(vecs, np.float32))


def write_binary_word_vectors(model: SequenceVectors, path: str):
    """Google News .bin format (reference writeBinary path)."""
    V, D = model.syn0.shape
    with open(path, "wb") as f:
        f.write(f"{V} {D}\n".encode())
        for i in range(V):
            f.write(model.vocab.word_at(i).encode("utf-8") + b" ")
            f.write(model.syn0[i].astype("<f4").tobytes())
            f.write(b"\n")


def read_binary_word_vectors(path: str) -> SequenceVectors:
    """Reference loadGoogleModel(binary=true)."""
    words, vecs = [], []
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").split()
        V, D = int(header[0]), int(header[1])
        for _ in range(V):
            w = bytearray()
            while True:
                c = f.read(1)
                if c in (b" ", b""):
                    break
                if c != b"\n":
                    w.extend(c)
            vec = np.frombuffer(f.read(4 * D), dtype="<f4")
            nl = f.read(1)
            if nl not in (b"\n", b""):
                f.seek(-1, 1)
            words.append(w.decode("utf-8"))
            vecs.append(vec)
    return _from_arrays(words, np.asarray(vecs, np.float32))


def _from_arrays(words, syn0) -> SequenceVectors:
    model = SequenceVectors(layer_size=syn0.shape[1])
    vc = VocabCache()
    for i, w in enumerate(words):
        vw = VocabWord(w, 1)
        vw.index = i
        vc.words[w] = vw
        vc._by_index.append(vw)
    vc.total_count = len(words)
    model.vocab = vc
    model.syn0 = syn0
    model.syn1neg = np.zeros_like(syn0)
    return model
