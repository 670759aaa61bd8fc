"""SequenceVectors: generic embedding trainer over element sequences.

Counterpart of ``deeplearning4j_tpu/nlp/sequence_vectors.py``. The host side
is the reference's, draw for draw: the vocabulary, the initial tables, the
sentence order, the subsampling, each sentence's reduced windows and the
negatives all come from one ``np.random.default_rng(seed)`` in the same
order, so both packages train on the same pairs and negatives. The device
side is one step, ``sv_step``: gather the rows a batch touches, take the
analytic gradients on them (``_sgns_grads``, ``_hs_grads``) and scatter-add
the updates into both tables in place. No dense ``[V, D]`` gradient exists,
so a step's cost follows the batch, not the vocabulary.

Three rules keep the step equal to the reference's ``.at[].add`` update:
- colliding rows add up: every update is an ``index_add_`` (on the card its
  adds are atomic, in no fixed order: the CPU and the card agree to
  rounding, not bitwise);
- every gradient comes from the tables before the step: all rows are
  gathered first, then the tables are updated;
- padded entries (CBOW's context slots, HS's path entries) point at row 0
  with mask 0, so their update is exactly zero.

A fit reads nothing back from the device between its first step and the
final copy of the tables to numpy: the loss stays a device scalar, the
batches go up from pinned host memory without a wait. The tables live on
the model's ``device`` (``device.py`` ``resolve_device``: the card unless
the caller names another) while a fit runs, and are numpy float32 arrays
after it, as in the reference.

Reference: models/sequencevectors/SequenceVectors.java (vocab
construction, SkipGram/CBOW elements learning, linear LR decay; the
SkipGram hot loop is the native AggregateSkipGram, SkipGram.java:271).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from .vocab import VocabCache


def _sgns_grads(v, u_pos, u_neg):
    """Analytic skip-gram-negative-sampling gradients on the GATHERED rows
    (reference ``_sgns_grads``).

    loss_row = softplus(-v.u_pos) + sum_k softplus(v.u_neg_k), per pair.
    v, u_pos: [..., D]; u_neg: [..., k, D]. Returns (grad_v, grad_u_pos,
    grad_u_neg, loss_row[...]), what autograd of the dense loss gives on
    these rows."""
    pos_logit = (v * u_pos).sum(-1)
    neg_logit = torch.einsum("...d,...kd->...k", v, u_neg)
    g_pos = torch.sigmoid(pos_logit) - 1.0             # dL/dpos_logit
    g_neg = torch.sigmoid(neg_logit)                   # dL/dneg_logit
    grad_v = g_pos[..., None] * u_pos + \
        torch.einsum("...k,...kd->...d", g_neg, u_neg)
    grad_u_pos = g_pos[..., None] * v
    grad_u_neg = g_neg[..., None] * v[..., None, :]
    loss_row = F.softplus(-pos_logit) + F.softplus(neg_logit).sum(-1)
    return grad_v, grad_u_pos, grad_u_neg, loss_row


def _hs_grads(v, u_path, codes, path_mask):
    """Analytic hierarchical-softmax gradients on the GATHERED inner-node
    rows (reference ``_hs_grads``): v [..., D], u_path [..., L, D] along
    the target's Huffman path, codes and path_mask [..., L]. word2vec's
    convention: label = 1 - code, loss = softplus((2 code - 1) logit).
    Returns (grad_v, grad_u [..., L, D], loss_row [...])."""
    logits = torch.einsum("...d,...ld->...l", v, u_path)
    g = (torch.sigmoid(logits) - (1.0 - codes)) * path_mask   # dL/dlogit
    grad_v = torch.einsum("...l,...ld->...d", g, u_path)
    grad_u = g[..., None] * v[..., None, :]
    loss_row = (F.softplus((2.0 * codes - 1.0) * logits) * path_mask).sum(-1)
    return grad_v, grad_u, loss_row


def sv_step(syn0, syn1, centers, targets, lr, ctx_mask=None, *, negs=None,
            codes=None, path_mask=None):
    """One batched step, in place on both tables; returns the mean loss a
    pair as a device scalar.

    centers: [B] rows of ``syn0`` (skip-gram), or [B, C] context rows
    averaged under ``ctx_mask`` [B, C] (CBOW, PV-DM). With ``negs`` [B, k]
    (negative sampling) ``targets`` [B] are the positive rows of ``syn1``;
    with ``codes`` and ``path_mask`` [B, L] (hierarchical softmax)
    ``targets`` [B, L] are the inner nodes on each target's Huffman path.
    Word2Vec, PV-DBOW, PV-DM and DistributedWord2Vec's CBOW all step here.
    """
    D = syn0.shape[1]
    if ctx_mask is None:
        v = syn0[centers]
    else:
        denom = ctx_mask.sum(1, keepdim=True).clamp_min(1.0)
        v = (syn0[centers] * ctx_mask[..., None]).sum(1) / denom
    if codes is None:
        grad_v, g_upos, g_uneg, loss_row = _sgns_grads(v, syn1[targets],
                                                       syn1[negs])
        syn1.index_add_(0, targets, -lr * g_upos)
        syn1.index_add_(0, negs.reshape(-1), (-lr * g_uneg).reshape(-1, D))
    else:
        grad_v, grad_u, loss_row = _hs_grads(v, syn1[targets], codes,
                                             path_mask)
        syn1.index_add_(0, targets.reshape(-1), (-lr * grad_u).reshape(-1, D))
    if ctx_mask is None:
        syn0.index_add_(0, centers, -lr * grad_v)
    else:
        # d(mean of context rows)/d(row c) = mask_c / denom
        per_ctx = grad_v[:, None, :] * (ctx_mask / denom)[..., None]
        syn0.index_add_(0, centers.reshape(-1), (-lr * per_ctx).reshape(-1, D))
    return loss_row.sum() / centers.shape[0]


def make_neg_sampling_step(lr: float, negative: int):
    """Standalone skip-gram NS step with negatives drawn uniformly on the
    device (reference ``make_neg_sampling_step``, the bulk-throughput entry
    point; a fit draws from the unigram table on the host, ``_flush``).
    ``generator`` is a ``torch.Generator`` on the tables' device, in place
    of the reference's PRNG key; the tables are updated in place."""

    def step(syn0, syn1, centers, contexts, generator):
        negs = torch.randint(0, syn1.shape[0], (centers.shape[0], negative),
                             generator=generator, device=syn1.device)
        sv_step(syn0, syn1, centers, contexts, lr, negs=negs)
        return syn0, syn1

    return step


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device``. To the card it goes from pinned
    memory without a wait (the host allocator keeps the staging block until
    the copy has run), so uploads inside a fit never stall the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def _upload_idx(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return _upload(np.asarray(a, np.int64), device)


def _download(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SequenceVectors:
    def __init__(self, *, layer_size: int = 100, window: int = 5,
                 min_word_frequency: int = 1, epochs: int = 1,
                 iterations: int = 1, negative: int = 5, sample: float = 0.0,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 batch_size: int = 8192, seed: int = 42,
                 learning_algorithm: str = "skipgram",
                 use_hierarchical_softmax: bool = False,
                 device: DeviceLike = None):
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.epochs = epochs
        self.iterations = iterations
        self.negative = negative
        self.sample = sample
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.batch_size = batch_size
        self.seed = seed
        self.learning_algorithm = learning_algorithm.lower()
        self.use_hierarchical_softmax = use_hierarchical_softmax
        # resolved when a fit (or a step) first needs it, so a model read
        # from a vectors file needs no card
        self.device = device
        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[np.ndarray] = None
        self.syn1neg: Optional[np.ndarray] = None   # NS output table
        self.syn1: Optional[np.ndarray] = None      # HS inner-node table
        self._huffman = None                        # (codes, points, mask)
        self._step = None

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    # ------------------------------------------------------------- training
    def _ensure_hs_tables(self):
        """Lazily build the padded Huffman path arrays and the inner-node
        output table (single owner of the max(V-1,1) shape; shared by the
        Word2Vec, PV-DBOW, PV-DM and infer_vector HS paths)."""
        if self._huffman is None:
            self._huffman = self.vocab.huffman_arrays()
        if self.syn1 is None:
            self.syn1 = np.zeros((max(len(self.vocab) - 1, 1),
                                  self.layer_size), np.float32)
        return self._huffman

    def _build_step(self):
        """The step with the reference's call shape, in place on the
        tables it is given: ``step(syn0, syn1, centers, contexts, negs, lr,
        ctx_mask=None)`` for negative sampling, ``step(syn0, syn1, centers,
        points, codes, mask, lr, ctx_mask=None)`` for hierarchical softmax;
        both return ``(syn0, syn1, mean loss)``."""
        if self.use_hierarchical_softmax:
            def hs_step(syn0, syn1, centers, pts, cds, msk, lr, ctx_mask=None):
                loss = sv_step(syn0, syn1, centers, pts, lr, ctx_mask,
                               codes=cds, path_mask=msk)
                return syn0, syn1, loss
            return hs_step

        def step(syn0, syn1, centers, contexts, negs, lr, ctx_mask=None):
            loss = sv_step(syn0, syn1, centers, contexts, lr, ctx_mask,
                           negs=negs)
            return syn0, syn1, loss
        return step

    def _pairs_for_sentence(self, idxs: np.ndarray, rng, keep_probs):
        """(center, context) pairs with per-center random reduced window
        (word2vec behavior, reference SkipGram.java:215). The reference's
        draws and its pair order (by center, then by context position),
        built with numpy instead of a Python loop."""
        if keep_probs is not None and len(idxs):
            keep = rng.random(len(idxs)) < keep_probs[idxs]
            idxs = idxs[keep]
        n = len(idxs)
        if n < 2:
            return np.empty((0, 2), np.int32)
        bs = rng.integers(1, self.window + 1, n)
        i = np.arange(n)
        lo, hi = np.maximum(0, i - bs), np.minimum(n, i + bs + 1)
        cnt = hi - lo
        rows = np.repeat(i, cnt)
        cols = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + \
            np.arange(cnt.sum())
        sel = cols != rows
        return np.stack([idxs[rows[sel]], idxs[cols[sel]]],
                        1).astype(np.int32)

    def fit(self, sequences: Iterable[List[str]]):
        """sequences: iterable of token lists (re-iterable across epochs)."""
        dev = self._device()
        seqs = list(sequences)
        self.vocab = VocabCache.build(seqs, self.min_word_frequency)
        self.vocab.build_huffman()
        V, D = len(self.vocab), self.layer_size
        rng = np.random.default_rng(self.seed)
        self.syn0 = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        if self.use_hierarchical_softmax:
            self._huffman = self.syn1 = None   # fresh fit: rebuild both
            self._ensure_hs_tables()
            syn1_host, table = self.syn1, None
        else:
            self.syn1neg = np.zeros((V, D), np.float32)
            syn1_host, table = self.syn1neg, self.vocab.unigram_table()
        keep_probs = self.vocab.subsample_keep_probs(self.sample)
        if self._step is None:
            self._step = self._build_step()

        idx_seqs = [np.asarray([self.vocab.index_of(w) for w in s
                                if w in self.vocab], np.int32) for s in seqs]
        syn0, syn1 = _upload(self.syn0, dev), _upload(syn1_host, dev)
        total_steps = max(1, self.epochs * self.iterations * len(idx_seqs))
        done = 0
        for _ in range(self.epochs):
            for _ in range(self.iterations):
                order = rng.permutation(len(idx_seqs))
                buf, size = [], 0
                for si in order:
                    p = self._pairs_for_sentence(idx_seqs[si], rng, keep_probs)
                    if len(p):
                        buf.append(p)
                        size += len(p)
                    done += 1
                    if size >= self.batch_size:
                        syn0, syn1 = self._flush(syn0, syn1, buf, table, rng,
                                                 done / total_steps)
                        buf, size = [], 0
                if buf:
                    syn0, syn1 = self._flush(syn0, syn1, buf, table, rng,
                                             done / total_steps)
        self.syn0 = _download(syn0)
        if self.use_hierarchical_softmax:
            self.syn1 = _download(syn1)
        else:
            self.syn1neg = _download(syn1)
        return self

    def _flush(self, syn0, syn1, buf, table, rng, progress):
        pairs = np.concatenate(buf)
        dev = syn0.device
        lr = max(self.min_learning_rate,
                 self.learning_rate * (1.0 - progress))
        cbow = self.learning_algorithm == "cbow"
        if self.use_hierarchical_softmax:
            codes, points, pmask = self._huffman
            if cbow:
                # pairs are (target, context): 1-context cbow predicts the
                # target word's Huffman path from the context row
                tgt = pairs[:, 0]
                centers = pairs[:, 1][:, None]
                cmask = torch.ones((len(pairs), 1), dtype=syn0.dtype,
                                   device=dev)
            else:
                # skipgram: center row predicts the CONTEXT word's path
                tgt = pairs[:, 1]
                centers, cmask = pairs[:, 0], None
            syn0, syn1, _ = self._step(
                syn0, syn1, _upload_idx(centers, dev),
                _upload_idx(points[tgt], dev), _upload(codes[tgt], dev),
                _upload(pmask[tgt], dev), lr, cmask)
            return syn0, syn1
        negs = table[rng.integers(0, len(table), (len(pairs), self.negative))]
        if cbow:
            # for cbow the "pairs" are (target, context): each pair is a
            # 1-context cbow example (equivalent math)
            centers = pairs[:, 1][:, None]
            mask = torch.ones(centers.shape, dtype=syn0.dtype, device=dev)
            syn0, syn1, _ = self._step(syn0, syn1, _upload_idx(centers, dev),
                                       _upload_idx(pairs[:, 0], dev),
                                       _upload_idx(negs, dev), lr, mask)
        else:
            syn0, syn1, _ = self._step(syn0, syn1,
                                       _upload_idx(pairs[:, 0], dev),
                                       _upload_idx(pairs[:, 1], dev),
                                       _upload_idx(negs, dev), lr)
        return syn0, syn1

    # -------------------------------------------------------------- queries
    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i]

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and word in self.vocab

    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.get_word_vector(w1), self.get_word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        return float(v1 @ v2 / denom) if denom else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            v = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
        else:
            v = np.asarray(word_or_vec)
            exclude = set()
        if v is None:
            return []
        norms = np.linalg.norm(self.syn0, axis=1) * np.linalg.norm(v)
        sims = self.syn0 @ v / np.maximum(norms, 1e-9)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out
