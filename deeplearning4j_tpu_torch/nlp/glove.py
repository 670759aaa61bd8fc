"""GloVe: co-occurrence counting + weighted least-squares factorization.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py``. The co-occurrence
counting and the minibatch order are the reference's host code; the
AdaGrad step runs on the model's device with the loss's gradient written
by hand (the reference takes ``jax.grad``): the gathered rows' gradients
are scatter-added into dense ``[V, D]`` and ``[V]`` gradients, so a pair
repeated in a batch adds up as the gather's transpose does, then all four
tables and their accumulators (which start at 1) take the update.

Reference: models/glove/Glove.java (429 LoC; AdaGrad on the GloVe objective),
models/glove/count/* (co-occurrence map with shadow-copy binned counting).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, List

import numpy as np
import torch

from .sequence_vectors import (SequenceVectors, _download, _upload,
                               _upload_idx)
from .vocab import VocabCache


def glove_step(params, accum, i, j, x, *, lr, x_max, alpha):
    """One AdaGrad step on the weighted least-squares loss
    ``sum f(x) (W[i].Wc[j] + b[i] + bc[j] - log x)^2``, in place on the
    four tables ``params`` = (W, Wc, b, bc) and their accumulators."""
    W, Wc, b, bc = params
    Wi, Wcj = W[i], Wc[j]
    pred = (Wi * Wcj).sum(-1) + b[i] + bc[j]
    f = torch.clamp((x / x_max) ** alpha, max=1.0)
    g = 2.0 * f * (pred - torch.log(x))                   # dL/dpred
    grads = (torch.zeros_like(W).index_add_(0, i, g[:, None] * Wcj),
             torch.zeros_like(Wc).index_add_(0, j, g[:, None] * Wi),
             torch.zeros_like(b).index_add_(0, i, g),
             torch.zeros_like(bc).index_add_(0, j, g))
    for p, gr, a in zip(params, grads, accum):
        a.add_(gr * gr)
        p.sub_(lr * gr / torch.sqrt(a))


class Glove(SequenceVectors):
    def __init__(self, *, x_max: float = 100.0, alpha: float = 0.75, **kwargs):
        kwargs.setdefault("learning_rate", 0.05)
        super().__init__(**kwargs)
        self.x_max = x_max
        self.alpha = alpha

    def fit(self, sequences: Iterable[List[str]]):
        dev = self._device()
        seqs = list(sequences)
        self.vocab = VocabCache.build(seqs, self.min_word_frequency)
        V, D = len(self.vocab), self.layer_size

        # ---- co-occurrence (symmetric, 1/d weighting like the paper/reference)
        cooc = defaultdict(float)
        for s in seqs:
            idxs = [self.vocab.index_of(w) for w in s if w in self.vocab]
            for i, wi in enumerate(idxs):
                for off in range(1, self.window + 1):
                    j = i + off
                    if j >= len(idxs):
                        break
                    a, b = wi, idxs[j]
                    if a == b:
                        continue
                    cooc[(a, b)] += 1.0 / off
                    cooc[(b, a)] += 1.0 / off
        if not cooc:
            raise ValueError("Empty co-occurrence matrix")
        ii = _upload_idx([k[0] for k in cooc], dev)
        jj = _upload_idx([k[1] for k in cooc], dev)
        xx = _upload(np.asarray(list(cooc.values()), np.float32), dev)

        rng = np.random.default_rng(self.seed)
        W = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        Wc = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        params = tuple(_upload(a, dev) for a in
                       (W, Wc, np.zeros(V, np.float32),
                        np.zeros(V, np.float32)))
        accum = tuple(torch.ones_like(p) for p in params)   # AdaGrad
        n = len(cooc)
        for _ in range(max(1, self.epochs)):
            order = _upload_idx(rng.permutation(n), dev)
            for s in range(0, n, self.batch_size):
                sel = order[s:s + self.batch_size]
                glove_step(params, accum, ii[sel], jj[sel], xx[sel],
                           lr=self.learning_rate, x_max=self.x_max,
                           alpha=self.alpha)
        W, Wc = _download(params[0]), _download(params[1])
        self.syn0 = W + Wc   # standard GloVe: sum of word+context vectors
        self.syn1neg = np.zeros_like(self.syn0)
        return self
