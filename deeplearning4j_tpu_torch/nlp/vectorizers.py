"""Bag-of-words / TF-IDF text vectorizers + DocumentIterator.

Counterpart of ``deeplearning4j_tpu/nlp/vectorizers.py``, copied unchanged
(numpy); ``vectorize`` returns the port's ``datasets/dataset.py``
``DataSet``.

Reference: deeplearning4j-nlp bagofwords/vectorizer/{BagOfWordsVectorizer,
TfidfVectorizer}.java (fit: build vocab + document frequencies over a corpus;
transform: text -> count / tf-idf vector; vectorize: (text, label) ->
DataSet) and text/documentiterator/DocumentIterator.java (stream of raw
documents; FileDocumentIterator walks a directory).
"""
from __future__ import annotations

import math
import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import DefaultTokenizerFactory, TokenizerFactory
from ..datasets.dataset import DataSet


class DocumentIterator:
    """Stream of raw document strings (reference DocumentIterator.java)."""

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self):
        pass


class CollectionDocumentIterator(DocumentIterator):
    def __init__(self, docs: Sequence[str]):
        self.docs = list(docs)

    def __iter__(self):
        return iter(self.docs)


class FileDocumentIterator(DocumentIterator):
    """One document per file under a directory (reference
    FileDocumentIterator.java)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        for root, _, files in os.walk(self.path):
            for name in sorted(files):
                with open(os.path.join(root, name), "r", errors="replace") as f:
                    yield f.read()


class BagOfWordsVectorizer:
    """Count vectorizer (reference BagOfWordsVectorizer.java)."""

    def __init__(self, *, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = set(stop_words)
        self.vocab: List[str] = []
        self.index = {}
        self.doc_freq: Optional[np.ndarray] = None
        self.n_docs = 0

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer_factory.create(text).get_tokens()
                if t not in self.stop_words]

    def fit(self, documents: Iterable[str]):
        counts = {}
        dfs = {}
        self.n_docs = 0
        for doc in documents:
            self.n_docs += 1
            toks = self._tokens(doc)
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
            for t in set(toks):
                dfs[t] = dfs.get(t, 0) + 1
        self.vocab = sorted(w for w, c in counts.items()
                            if c >= self.min_word_frequency)
        self.index = {w: i for i, w in enumerate(self.vocab)}
        self.doc_freq = np.asarray([dfs.get(w, 0) for w in self.vocab],
                                   np.float64)
        self._idf = None     # invalidate any cached idf on refit
        return self

    def transform(self, text: str) -> np.ndarray:
        v = np.zeros(len(self.vocab), np.float32)
        for t in self._tokens(text):
            i = self.index.get(t)
            if i is not None:
                v[i] += 1.0
        return v

    def transform_documents(self, documents: Iterable[str]) -> np.ndarray:
        return np.stack([self.transform(d) for d in documents])

    def vectorize(self, text: str, label: str, labels: Sequence[str]) -> DataSet:
        """(text, label) -> DataSet with one-hot label (reference
        BaseTextVectorizer.vectorize)."""
        y = np.zeros(len(labels), np.float32)
        y[list(labels).index(label)] = 1.0
        return DataSet(self.transform(text)[None, :], y[None, :])


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF weighting (reference TfidfVectorizer.java: tf = raw count,
    idf = log(n_docs / doc_freq), smoothed here to avoid division by zero)."""

    def idf(self) -> np.ndarray:
        if getattr(self, "_idf", None) is None:
            self._idf = np.log((1.0 + self.n_docs)
                               / (1.0 + self.doc_freq)) + 1.0
        return self._idf

    def transform(self, text: str) -> np.ndarray:
        counts = super().transform(text)
        return (counts * self.idf()).astype(np.float32)

    def tfidf_word(self, word: str, text: str) -> float:
        i = self.index.get(word)
        if i is None:
            return 0.0
        return float(self.transform(text)[i])
