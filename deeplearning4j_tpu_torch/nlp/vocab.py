"""Vocabulary construction: counts, indices, Huffman coding, subsampling.

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py``, copied unchanged
(numpy): the same build order, Huffman codes and points, padded
``huffman_arrays`` and the same ``unigram_table`` draws
(``np.random.default_rng(7)``), so the port's negatives equal the
reference's bit for bit.

Reference: models/word2vec/wordstore/inmemory/AbstractCache.java (vocab),
models/word2vec/Huffman.java (binary-tree codes for hierarchical softmax),
vocab construction in SequenceVectors.buildVocab (:161-176).
"""
from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class VocabWord:
    __slots__ = ("word", "count", "index", "code", "points")

    def __init__(self, word: str, count: int = 1):
        self.word = word
        self.count = count
        self.index = -1
        self.code: List[int] = []      # Huffman bits
        self.points: List[int] = []    # inner-node indices on path


class VocabCache:
    """Word store (reference AbstractCache)."""

    def __init__(self):
        self.words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_count = 0

    def __len__(self):
        return len(self._by_index)

    def __contains__(self, w):
        return w in self.words

    def word_for(self, w: str) -> Optional[VocabWord]:
        return self.words.get(w)

    def index_of(self, w: str) -> int:
        vw = self.words.get(w)
        return vw.index if vw else -1

    def word_at(self, idx: int) -> str:
        return self._by_index[idx].word

    def word_frequency(self, w: str) -> int:
        vw = self.words.get(w)
        return vw.count if vw else 0

    @staticmethod
    def build(token_stream: Iterable[List[str]], min_word_frequency: int = 1
              ) -> "VocabCache":
        counts = Counter()
        total = 0
        for tokens in token_stream:
            counts.update(tokens)
            total += len(tokens)
        vc = VocabCache()
        # frequency-descending indices (reference behavior; also optimal for
        # the unigram-table negative sampler)
        for i, (w, c) in enumerate(sorted(
                ((w, c) for w, c in counts.items() if c >= min_word_frequency),
                key=lambda t: (-t[1], t[0]))):
            vw = VocabWord(w, c)
            vw.index = i
            vc.words[w] = vw
            vc._by_index.append(vw)
        vc.total_count = total
        return vc

    def build_huffman(self):
        """Assign Huffman codes/points (reference Huffman.java) for
        hierarchical softmax."""
        n = len(self._by_index)
        if n == 0:
            return
        heap = [(vw.count, i, i) for i, vw in enumerate(self._by_index)]
        heapq.heapify(heap)
        parents: Dict[int, tuple] = {}
        next_id = n
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parents[n1] = (next_id, 0)
            parents[n2] = (next_id, 1)
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2]
        for i, vw in enumerate(self._by_index):
            code, points = [], []
            node = i
            while node != root:
                parent, bit = parents[node]
                code.append(bit)
                points.append(parent - n)   # inner node index
                node = parent
            vw.code = code[::-1]
            vw.points = points[::-1]

    def huffman_arrays(self):
        """Pad the per-word Huffman paths to rectangular arrays for the
        batched-gather hierarchical-softmax step (the TPU-shaped form of the
        reference's per-word tree walk, SkipGram.java:238ff):
        (codes [V,L] float32, points [V,L] int32, mask [V,L] float32) with
        L = max code length. Padded entries point at inner node 0 with mask 0,
        so their scatter-add contribution is exactly zero."""
        if self._by_index and not self._by_index[0].code and len(self._by_index) > 1:
            self.build_huffman()
        V = len(self._by_index)
        L = max((len(vw.code) for vw in self._by_index), default=1) or 1
        codes = np.zeros((V, L), np.float32)
        points = np.zeros((V, L), np.int32)
        mask = np.zeros((V, L), np.float32)
        for i, vw in enumerate(self._by_index):
            n = len(vw.code)
            codes[i, :n] = vw.code
            points[i, :n] = vw.points
            mask[i, :n] = 1.0
        return codes, points, mask

    def unigram_table(self, size: int = 1 << 20, power: float = 0.75) -> np.ndarray:
        """Negative-sampling table (word2vec unigram^0.75 distribution; the
        reference delegates this to ND4J's native AggregateSkipGram)."""
        freqs = np.array([vw.count for vw in self._by_index], np.float64) ** power
        probs = freqs / freqs.sum()
        return np.random.default_rng(7).choice(
            len(self._by_index), size=size, p=probs).astype(np.int32)

    def subsample_keep_probs(self, sample: float) -> Optional[np.ndarray]:
        """Frequent-word subsampling keep-probabilities (word2vec ``sample``)."""
        if not sample or sample <= 0:
            return None
        freqs = np.array([vw.count for vw in self._by_index], np.float64)
        f = freqs / max(self.total_count, 1)
        keep = (np.sqrt(f / sample) + 1) * (sample / np.maximum(f, 1e-12))
        return np.minimum(keep, 1.0)
