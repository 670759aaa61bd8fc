"""Solver: the training loop's per-step SGD path and truncated BPTT.

Counterpart of ``deeplearning4j_tpu/optimize/solver.py``:
``train_step_math`` (``:33-74``) as loss -> ``torch.autograd.grad`` ->
updater, the tBPTT chunk step and loop (``_get_tbptt_step`` /
``_fit_tbptt_batch``, ``:168-247``), and ``Solver.fit``'s per-step branch
(``:250-304``, ``:508-581``) with its iteration counter and ``cast_feed``
(``:725-750``), which keeps integer token ids and casts float features,
labels and masks to the net's dtype. It trains a ``ComputationGraph`` or a
``MultiLayerNetwork``: the updater's layers are keyed by vertex name or by
layer index.

Each step runs eagerly: the forward, the backward (through the flash or
LSTM kernels on the card) and the in-place updater. Under tBPTT
(``backprop_type == "tbptt"``) a batch's time-series features, labels and
masks are cut into chunks of ``tbptt_fwd_length`` steps; each chunk is one
iteration, and each recurrent layer's final (h, c) carries into the next
chunk detached, as the reference's ``stop_gradient``. Dropout draws from
one ``torch.Generator`` on the net's device, reseeded every iteration from
the configuration's seed and the iteration count, as the reference folds
the iteration into its key. Fused multi-step windows, device prefetch
(ROADMAP A10), tBPTT on a ComputationGraph (A10), second-order solvers
(A5), multi-input feeds and the mid-epoch resume (``skip_first_batches``,
with checkpointing, A10) are not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..datasets.dataset import ListDataSetIterator


def _descend(net, loss, it: int) -> None:
    """Gradients of ``loss`` with respect to every parameter of a layer
    that is not frozen, then the updater in place at iteration ``it``."""
    params = net.param_dicts()
    trainable = [(name, k, p) for name, pd in params.items()
                 if not getattr(net.updater.layer_confs[name], "frozen",
                                False)
                 for k, p in pd.items()]
    gs = torch.autograd.grad(loss, [p for _, _, p in trainable])
    grads = {}
    for (name, k, _), g in zip(trainable, gs):
        grads.setdefault(name, {})[k] = g
    net.updater.update(grads, net.opt_state, params, it)


def train_step_math(net, x, y, lmask=None, fmask=None, *,
                    gen: Optional[torch.Generator] = None,
                    it: int) -> torch.Tensor:
    """One step: the loss at the current parameters, then ``_descend``.
    Returns the loss (detached)."""
    loss = net.loss_fn(x, y, train=True, gen=gen, labels_mask=lmask,
                       features_mask=fmask)
    _descend(net, loss, it)
    return loss.detach()


def tbptt_step_math(net, x, y, lmask, fmask, rnn_states, *,
                    gen: Optional[torch.Generator] = None, it: int):
    """One tBPTT chunk: the loss from the carried ``rnn_states`` (None on
    the first chunk: zero states), then ``_descend``. Returns the loss and
    each recurrent layer's final (h, c), both detached."""
    loss, rnn_out = net.loss_fn(x, y, train=True, gen=gen, labels_mask=lmask,
                                features_mask=fmask, rnn_states=rnn_states,
                                collect_rnn_states=True)
    _descend(net, loss, it)
    carry = [None if s is None else tuple(v.detach() for v in s)
             for s in rnn_out]
    return loss.detach(), carry


def score_listeners(listeners) -> list:
    """Check that each listener is a score callback,
    ``listener.iteration_done(net, iteration, loss)``. Epoch and performance
    listeners come with telemetry (ROADMAP A8)."""
    for lis in listeners:
        if not hasattr(lis, "iteration_done"):
            raise TypeError(f"{type(lis).__name__} has no "
                            f"iteration_done(net, iteration, loss)")
        if hasattr(lis, "on_epoch_start") or hasattr(lis, "note_batch"):
            raise NotImplementedError(
                f"{type(lis).__name__}: epoch and performance listeners "
                f"are not ported yet (ROADMAP A8)")
    return list(listeners)


def cast_feed(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The feed-boundary cast: onto ``device``; integer arrays (token ids)
    keep their type, everything else takes ``dtype``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    keep = not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)
    return t.to(device=device, dtype=None if keep else dtype)


class Solver:
    def __init__(self, net):
        self.net = net

    def fit(self, data=None, labels=None, *, epochs=1, batch_size=None,
            iterator=None, dataset=None, async_prefetch: bool = False,
            steps_per_dispatch: int = 1):
        net = self.net
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if steps_per_dispatch > 1:
            raise NotImplementedError("fused multi-step windows "
                                      "(steps_per_dispatch > 1) are not "
                                      "ported yet (ROADMAP A10)")
        if async_prefetch:
            raise NotImplementedError("device prefetch (async_prefetch) is "
                                      "not ported yet (ROADMAP A10)")
        if not net.initialized:
            net.init()
        if iterator is None:
            if dataset is not None:
                iterator = ListDataSetIterator([dataset])
            else:
                if not isinstance(data, torch.Tensor):
                    data = np.asarray(data)
                if not isinstance(labels, torch.Tensor):
                    labels = np.asarray(labels)
                iterator = ListDataSetIterator(
                    features=data, labels=labels,
                    batch_size=batch_size or data.shape[0])
        gen = torch.Generator(device=net.device)
        base_seed = net.conf.seed + 7919
        dtype, device = net.dtype, net.device
        tbptt = getattr(net.conf, "backprop_type", "standard") == "tbptt"
        for _ in range(epochs):
            for ds in iterator:
                x = cast_feed(ds.features, dtype, device)
                y = cast_feed(ds.labels, dtype, device)
                lmask = None if ds.labels_mask is None \
                    else cast_feed(ds.labels_mask, dtype, device)
                fmask = None if ds.features_mask is None \
                    else cast_feed(ds.features_mask, dtype, device)
                if tbptt:
                    loss = self._fit_tbptt_batch(x, y, lmask, fmask, gen,
                                                 base_seed)
                    done = net.iteration_count - 1
                else:
                    gen.manual_seed((base_seed << 32) + net.iteration_count)
                    loss = train_step_math(net, x, y, lmask, fmask, gen=gen,
                                           it=net.iteration_count)
                    done = net.iteration_count
                    net.iteration_count += 1
                for lis in net.listeners:
                    lis.iteration_done(net, done, loss)
            if hasattr(iterator, "reset"):
                iterator.reset()
        return net

    def _fit_tbptt_batch(self, x, y, lmask, fmask, gen, base_seed):
        """Chunked tBPTT over the time axis: [B,T,F] features and labels
        and [B,T] masks are cut into chunks of ``tbptt_fwd_length`` steps,
        one iteration each; static 2-D arrays feed every chunk whole.
        Returns the last chunk's loss."""
        net = self.net
        time_lens = {v.shape[1] for v in (x, y) if v.dim() == 3}
        if not time_lens:
            raise ValueError("tBPTT requires a [B,T,F] time-series input or "
                             "label")
        if len(time_lens) > 1:
            raise ValueError(f"tBPTT requires the time-series input and "
                             f"labels to share one sequence length, got "
                             f"{sorted(time_lens)}")
        T = time_lens.pop()
        k = net.conf.tbptt_fwd_length
        cut3 = lambda v, t0, t1: v[:, t0:t1] if v.dim() == 3 else v
        cut2 = lambda m, t0, t1: (m[:, t0:t1] if m is not None
                                  and m.dim() == 2 else m)
        rnn_states, loss = None, None
        for t0 in range(0, T, k):
            t1 = min(t0 + k, T)
            gen.manual_seed((base_seed << 32) + net.iteration_count)
            loss, rnn_states = tbptt_step_math(
                net, cut3(x, t0, t1), cut3(y, t0, t1), cut2(lmask, t0, t1),
                cut2(fmask, t0, t1), rnn_states, gen=gen,
                it=net.iteration_count)
            net.iteration_count += 1
        return loss
