"""Word2Vec + ParagraphVectors on the SequenceVectors engine.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py``. Every device step
is ``sequence_vectors.sv_step`` (PV-DBOW with the document table in
``syn0``'s place, PV-DM as CBOW over the combined ``[V words ; docs]``
table); the host draws are the reference's. ``infer_vector`` takes its
gradient by hand through the same analytic gradients (the reference takes
``jax.grad`` of the same loss). It seeds its generator with
``abs(hash(text)) % 2**31`` as the reference does: Python salts ``str``
hashes per process, so an inferred vector repeats only within one
process, in either package.

Reference: models/word2vec/Word2Vec.java:32 (configured over
SequenceVectors; text pipeline = SentenceIterator + TokenizerFactory),
models/paragraphvectors/ParagraphVectors.java (PV-DBOW/PV-DM,
learning/impl/sequence/{DBOW,DM}.java, inferVector for unseen docs).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .sentence_iterator import LabelAwareIterator, SentenceIterator
from .sequence_vectors import (SequenceVectors, _download, _hs_grads,
                               _sgns_grads, _upload, _upload_idx)
from .tokenizer import DefaultTokenizerFactory, TokenizerFactory


class Word2Vec(SequenceVectors):
    def __init__(self, *, iterate: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.iterate = iterate
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _token_stream(self):
        for sentence in self.iterate:
            yield self.tokenizer_factory.create(sentence).get_tokens()

    def fit(self, sentences: Optional[Sequence[str]] = None):
        if sentences is not None:
            from .sentence_iterator import CollectionSentenceIterator
            self.iterate = CollectionSentenceIterator(list(sentences))
        if self.iterate is None:
            raise ValueError("Word2Vec needs a SentenceIterator (iterate=...)")
        return super().fit(self._token_stream())


class ParagraphVectors(SequenceVectors):
    """Doc2vec. PV-DBOW (default): each document's label vector predicts the
    document's words (reference learning/impl/sequence/DBOW.java). PV-DM
    (``dm=True``): the doc vector is averaged WITH the context-window word
    vectors to predict the target word (reference DM.java — mean variant).
    PV-DM rides the engine's CBOW step over a combined [words ; docs]
    embedding table, so the update stays scatter-add-only."""

    def __init__(self, *, iterate: Optional[LabelAwareIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 train_words: bool = True, dm: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.iterate = iterate
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.train_words = train_words
        self.dm = dm
        self.doc_labels: List[str] = []
        self.doc_vectors: Optional[np.ndarray] = None

    def fit(self, docs=None):
        """docs: optional [(label, content)] pairs."""
        if docs is not None:
            from .sentence_iterator import SimpleLabelAwareIterator
            self.iterate = SimpleLabelAwareIterator(list(docs))
        if self.iterate is None:
            raise ValueError("ParagraphVectors needs a LabelAwareIterator")
        dev = self._device()
        docs_tok = []
        for d in self.iterate:
            toks = self.tokenizer_factory.create(d.content).get_tokens()
            docs_tok.append((d.labels[0], toks))
        self.doc_labels = [l for l, _ in docs_tok]
        # 1) word vectors via plain skipgram over the corpus
        if self.train_words:
            super().fit([t for _, t in docs_tok])
        else:
            from .vocab import VocabCache
            self.vocab = VocabCache.build([t for _, t in docs_tok],
                                          self.min_word_frequency)
            rng = np.random.default_rng(self.seed)
            V, D = len(self.vocab), self.layer_size
            self.syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
            self.syn1neg = np.zeros((V, D), np.float32)
            if self._step is None:
                self._step = self._build_step()
        if self.dm:
            return self._fit_dm(docs_tok)
        # 2) PV-DBOW: doc vector predicts its words — against syn1neg
        # (negative sampling) or the Huffman inner-node table (HS), exactly
        # the objective the word phase used
        hs = self.use_hierarchical_softmax
        rng = np.random.default_rng(self.seed + 1)
        D = self.layer_size
        dvec = ((rng.random((len(docs_tok), D)) - 0.5) / D).astype(np.float32)
        if hs:
            codes, points, pmask = self._ensure_hs_tables()
            syn1, table = _upload(self.syn1, dev), None
        else:
            table = self.vocab.unigram_table()
            syn1 = _upload(self.syn1neg, dev)
        dvec = _upload(dvec, dev)
        step = self._step
        for epoch in range(max(1, self.epochs)):
            pairs = []
            for di, (_, toks) in enumerate(docs_tok):
                for w in toks:
                    wi = self.vocab.index_of(w)
                    if wi >= 0:
                        pairs.append((di, wi))
            pairs = np.asarray(pairs, np.int32)
            rng.shuffle(pairs)
            lr = max(self.min_learning_rate,
                     self.learning_rate * (1 - epoch / max(1, self.epochs)))
            for s in range(0, len(pairs), self.batch_size):
                chunk = pairs[s:s + self.batch_size]
                if hs:
                    w = chunk[:, 1]
                    dvec, syn1, _ = step(dvec, syn1,
                                         _upload_idx(chunk[:, 0], dev),
                                         _upload_idx(points[w], dev),
                                         _upload(codes[w], dev),
                                         _upload(pmask[w], dev), lr)
                else:
                    negs = table[rng.integers(0, len(table),
                                              (len(chunk), self.negative))]
                    dvec, syn1, _ = step(dvec, syn1,
                                         _upload_idx(chunk[:, 0], dev),
                                         _upload_idx(chunk[:, 1], dev),
                                         _upload_idx(negs, dev), lr)
        self.doc_vectors = _download(dvec)
        if hs:
            self.syn1 = _download(syn1)
        else:
            self.syn1neg = _download(syn1)
        return self

    def _fit_dm(self, docs_tok):
        """PV-DM mean variant over a combined [V words ; n docs] table: each
        training example's 'context set' = window words + the doc's row
        (index V+di); the engine's CBOW step averages and scatter-updates the
        combined table (reference DM.java semantics, batched)."""
        dev = self._device()
        rng = np.random.default_rng(self.seed + 2)
        V, D = len(self.vocab), self.layer_size
        n_docs = len(docs_tok)
        dvec = ((rng.random((n_docs, D)) - 0.5) / D).astype(np.float32)
        combined = _upload(np.vstack([np.asarray(self.syn0), dvec]), dev)
        # targets/negatives are always word indices < V, so syn1 needs no
        # doc rows
        hs = self.use_hierarchical_softmax
        if hs:
            codes, points, pmask = self._ensure_hs_tables()
            syn1, table = _upload(self.syn1, dev), None
        else:
            syn1 = _upload(self.syn1neg, dev)
            table = self.vocab.unigram_table()
        C = 2 * self.window + 1          # window words + doc row
        cbow_step = SequenceVectors(
            layer_size=D, window=self.window, negative=self.negative,
            learning_algorithm="cbow",
            use_hierarchical_softmax=hs)._build_step()
        idx_docs = [np.asarray([self.vocab.index_of(w) for w in toks
                                if w in self.vocab], np.int32)
                    for _, toks in docs_tok]
        # training examples are epoch-invariant — build once, permute per epoch
        centers, mask_lens, targets = [], [], []
        for di, idxs in enumerate(idx_docs):
            for t in range(len(idxs)):
                lo, hi = max(0, t - self.window), min(len(idxs), t + self.window + 1)
                ctx = [idxs[j] for j in range(lo, hi) if j != t]
                centers.append(ctx + [V + di] + [0] * (C - len(ctx) - 1))
                mask_lens.append(len(ctx) + 1)
                targets.append(idxs[t])
        ctr_all = np.asarray(centers, np.int32)
        msk_all = (np.arange(C)[None, :]
                   < np.asarray(mask_lens)[:, None]).astype(np.float32)
        tgt_all = np.asarray(targets, np.int32)
        for epoch in range(max(1, self.epochs)):
            order = rng.permutation(len(ctr_all))
            lr = max(self.min_learning_rate,
                     self.learning_rate * (1 - epoch / max(1, self.epochs)))
            ctr, msk, tgt = ctr_all[order], msk_all[order], tgt_all[order]
            for s in range(0, len(ctr), self.batch_size):
                sl = slice(s, s + self.batch_size)
                if hs:
                    w = tgt[sl]
                    combined, syn1, _ = cbow_step(
                        combined, syn1, _upload_idx(ctr[sl], dev),
                        _upload_idx(points[w], dev), _upload(codes[w], dev),
                        _upload(pmask[w], dev), lr, _upload(msk[sl], dev))
                else:
                    negs = table[rng.integers(0, len(table),
                                              (len(tgt[sl]), self.negative))]
                    combined, syn1, _ = cbow_step(
                        combined, syn1, _upload_idx(ctr[sl], dev),
                        _upload_idx(tgt[sl], dev), _upload_idx(negs, dev), lr,
                        _upload(msk[sl], dev))
        combined = _download(combined)
        self.syn0 = combined[:V]
        self.doc_vectors = combined[V:]
        if hs:
            self.syn1 = _download(syn1)
        else:
            self.syn1neg = _download(syn1)
        return self

    def get_doc_vector(self, label: str) -> Optional[np.ndarray]:
        try:
            return self.doc_vectors[self.doc_labels.index(label)]
        except ValueError:
            return None

    def _context_sums(self, widx):
        """PV-DM inference's frozen part: each position's sum of its window
        words' rows and 1 + their count (the doc vector's share)."""
        W = self.window
        ctx_sum = np.zeros((len(widx), self.layer_size), np.float32)
        n_ctx = np.zeros((len(widx), 1), np.float32)
        s0 = np.asarray(self.syn0)
        for t in range(len(widx)):
            lo, hi = max(0, t - W), min(len(widx), t + W + 1)
            ctx = [widx[j] for j in range(lo, hi) if j != t]
            if ctx:
                ctx_sum[t] = s0[ctx].sum(0)
            n_ctx[t, 0] = len(ctx)
        return ctx_sum, n_ctx + 1.0

    def infer_vector(self, text: str, steps: int = 20,
                     learning_rate: Optional[float] = None) -> np.ndarray:
        """Gradient-fit a fresh doc vector against frozen weights (reference
        ParagraphVectors.inferVector), using the configured algorithm:
        DBOW (doc vector alone predicts each word) or DM (doc vector averaged
        with frozen context word vectors predicts each target). The loss is
        the mean over the text's words; its gradient is the analytic one of
        the training step, averaged."""
        toks = self.tokenizer_factory.create(text).get_tokens()
        widx = np.asarray([self.vocab.index_of(w) for w in toks
                           if w in self.vocab], np.int32)
        rng = np.random.default_rng(abs(hash(text)) % (2 ** 31))
        v0 = ((rng.random(self.layer_size) - 0.5) /
              self.layer_size).astype(np.float32)
        if len(widx) == 0:
            return v0
        dev = self._device()
        v = _upload(v0, dev)
        lr = learning_rate or self.learning_rate
        if self.dm:
            ctx_sum, denom = (_upload(a, dev)
                              for a in self._context_sums(widx))
        else:
            ctx_sum = denom = None

        def predictor(v):
            if ctx_sum is None:
                return v.expand(len(widx), -1)
            return (ctx_sum + v[None, :]) / denom          # [T, D]

        def mean_grad(grad_rows):
            if denom is not None:
                grad_rows = grad_rows / denom
            return grad_rows.mean(0)

        if self.use_hierarchical_softmax:
            codes, points, pmask = self._ensure_hs_tables()
            u = _upload(self.syn1, dev)[_upload_idx(points[widx], dev)]
            cds, msk = _upload(codes[widx], dev), _upload(pmask[widx], dev)
            for s in range(steps):
                grad_rows, _, _ = _hs_grads(predictor(v), u, cds, msk)
                v = v - (lr * (1 - s / steps) + 1e-4) * mean_grad(grad_rows)
            return _download(v)
        syn1 = _upload(self.syn1neg, dev)
        table = self.vocab.unigram_table()
        u_pos = syn1[_upload_idx(widx, dev)]
        for s in range(steps):
            negs = table[rng.integers(0, len(table), (len(widx), self.negative))]
            grad_rows, _, _, _ = _sgns_grads(predictor(v), u_pos,
                                             syn1[_upload_idx(negs, dev)])
            v = v - (lr * (1 - s / steps) + 1e-4) * mean_grad(grad_rows)
        return _download(v)

    def similarity_to_label(self, text: str, label: str) -> float:
        v1 = self.infer_vector(text)
        v2 = self.get_doc_vector(label)
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(v1 @ v2 / denom) if denom else 0.0
