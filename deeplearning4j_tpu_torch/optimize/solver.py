"""Solver: the training loop's per-step SGD path.

Counterpart of ``deeplearning4j_tpu/optimize/solver.py``:
``train_step_math`` (``:33-74``) as loss -> ``torch.autograd.grad`` ->
updater, and ``Solver.fit``'s per-step branch (``:250-304``,
``:508-581``) with its iteration counter and ``cast_feed`` (``:725-750``),
which keeps integer token ids and casts float features, labels and masks
to the net's dtype.

Each step runs eagerly: the forward, the backward (through the flash
kernels on the card) and the in-place updater. Dropout draws from one
``torch.Generator`` on the net's device, reseeded every iteration from the
configuration's seed and the iteration count, as the reference folds the
iteration into its key. Fused multi-step windows, device prefetch
(ROADMAP A10), tBPTT (A4), second-order solvers (A5), multi-input feeds
and the mid-epoch resume (``skip_first_batches``, with checkpointing,
A10) are not ported.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..datasets.dataset import ListDataSetIterator


def train_step_math(net, x, y, lmask=None, fmask=None, *,
                    gen: Optional[torch.Generator] = None,
                    it: int) -> torch.Tensor:
    """One step: the loss at the current parameters, its gradients with
    respect to every parameter of a layer that is not frozen, then the
    updater in place at iteration ``it``. Returns the loss (detached)."""
    params = net.param_dicts()
    trainable = [(name, k, p) for name, pd in params.items()
                 if not getattr(net.updater.layer_confs[name], "frozen",
                                False)
                 for k, p in pd.items()]
    loss = net.loss_fn(x, y, train=True, gen=gen, labels_mask=lmask,
                       features_mask=fmask)
    gs = torch.autograd.grad(loss, [p for _, _, p in trainable])
    grads = {}
    for (name, k, _), g in zip(trainable, gs):
        grads.setdefault(name, {})[k] = g
    net.updater.update(grads, net.opt_state, params, it)
    return loss.detach()


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
        for _ in range(epochs):
            for ds in iterator:
                x = cast_feed(ds.features, dtype, device)
                y = cast_feed(ds.labels, dtype, device)
                lmask = None if ds.labels_mask is None \
                    else cast_feed(ds.labels_mask, dtype, device)
                fmask = None if ds.features_mask is None \
                    else cast_feed(ds.features_mask, dtype, device)
                gen.manual_seed((base_seed << 32) + net.iteration_count)
                loss = train_step_math(net, x, y, lmask, fmask, gen=gen,
                                       it=net.iteration_count)
                for lis in net.listeners:
                    lis.iteration_done(net, net.iteration_count, loss)
                net.iteration_count += 1
            if hasattr(iterator, "reset"):
                iterator.reset()
        return net
