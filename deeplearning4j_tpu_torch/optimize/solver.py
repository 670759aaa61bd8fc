"""Solver: the training loop.

Counterpart of ``deeplearning4j_tpu/optimize/solver.py``:
``train_step_math`` (``:33-74``) as loss -> ``torch.autograd.grad`` ->
updater, the tBPTT chunk step and loop (``_get_tbptt_step`` /
``_fit_tbptt_batch``, ``:168-247``), ``Solver.fit`` and ``_fit_epoch``
(``:250-597``), ``Solver.pretrain`` (``:599-716``) and the feed casts
(``_is_multi``, ``cast_feed``, ``:718-750``), which keep integer token
ids and cast float features, labels and masks to the net's dtype. It
trains a ``ComputationGraph`` or a ``MultiLayerNetwork``: the updater's
layers are keyed by vertex name or by layer index.

- **The step.** The forward, the backward (through the flash or LSTM
  kernels on the card) and the in-place updater at the iteration, which is
  a 0-dim integer tensor on the net's device filled before each step
  (``optimize/updaters.py``), then the layer state the forward computed
  (a BatchNormalization's running statistics) written into the layers'
  buffers once (``nn/tape.py`` ``collect_state``): a remat
  recompute or a CUDA graph's replay writes it no second time. Dropout draws from one ``torch.Generator``
  on the net's device, reseeded every iteration from the configuration's
  seed and the iteration count, as the reference folds the iteration into
  its key.
- **Feeds.** Iterator feeds run through a ``DevicePrefetchIterator`` by
  default (``async_prefetch=True, prefetch_depth=2``, as the reference's),
  so batch N+1 is staged and copied while step N computes. Lists of arrays
  (``MultiDataSet``s) feed a multi-input, multi-output graph.
- **Windows.** ``steps_per_dispatch=K`` groups the batches into windows of
  K same-shape batches (``iter_windows``, after ``skip_first_batches``).
  On the card a window's steps are replays of one captured step
  (``optimize/step_graph.py``), so its host cost is K copies and replays;
  on the CPU they run eagerly. Either way a step is ``train_step_math`` at
  the step's iteration and seed, so a window equals K single steps. Its
  losses are device tensors handed to the listeners after the window
  (the reference's deferred-score protocol: no host read a step). A
  ragged tail or an unstackable group runs per step; tBPTT ignores K.
- **tBPTT** (``backprop_type == "tbptt"``), on either network kind: a
  batch's time-series features, labels and masks are cut into chunks of
  ``tbptt_fwd_length`` steps; each chunk is one iteration, and each
  recurrent layer's final (h, c) carries into the next chunk detached, as
  the reference's ``stop_gradient``.

- **Second-order solvers** (``optimization_algorithm`` other than
  "sgd"): one outer iteration of ``optimize/second_order.py``'s solver a
  batch, per step (no windows, no CUDA graph: its line search reads each
  trial's score on the host), refused under tBPTT, as the reference's.
- **Layerwise pretraining** (``pretrain``, ``:599-716``): each layer with
  a ``pretrain_loss``, in order, is fed the data forward through the
  earlier layers (no gradient; a graph's layer vertex takes its input
  vertex's activations) and trained on that loss with its own rule and
  updater state, from iteration 0; its noise draws from a generator
  reseeded with the iteration and the layer's index, as the reference
  folds ``it * 1000 + index`` into its key.

- **Listeners** (``optimize/listeners.py``; reference ``:305, 370-372,
  487-497, 561-584``): ``on_epoch_start`` / ``on_epoch_end`` around each
  epoch of ``fit`` on every listener that has them, ``note_window(k)``
  before a window's K-step fan-out and ``note_batch(n, etl_wait_ms=...,
  device_ms=...)`` a batch on each listener that has them, then
  ``iteration_done`` with the iteration just run, before the count moves
  past it (``notify_window`` / ``notify_batch``, which ``ParallelWrapper``
  shares). The wait is the prefetcher's (``EtlClock``). ``pretrain``
  fires no epoch hooks, as the reference's does not.

- **Telemetry** (reference ``:319-520``): a fit runs under the caller's
  trace context or a fresh one, inside the ``fit`` -> ``epoch`` ->
  ``window`` -> ``dispatch`` spans (a batch outside a window: ``step``),
  with the ``train.iterations`` / ``train.windows`` counters. Before it
  starts the parameters and optimiser state are tagged for the memory
  profiler (``params``, ``opt_state``). On the SGD paths each dispatch's
  wait, dispatch and host times go to ``telemetry.StepAccounting``
  (``perf.step.*``, ``perf.fit.dispatch_ms`` for a window), and the first
  eager step of each shape is counted into the cost index
  (``fit/epoch/step``, or ``fit/epoch/window`` with K steps a call: the
  window's warm step; ``telemetry/perf.py``). With a ``TrainingWatch``
  armed (``telemetry.set_training_watch``) each step also returns its
  ``[3]`` health vector (``training_health_vec`` on the gradients, before
  the update: a read only), which the watch buffers on this thread and
  reads on its own; a window's rows come out of the CUDA graph through
  ``WindowGraphs``' per-replay copies. At each epoch's end the device
  memory gauges are read, the accounting flushed and the cost index
  folded. tBPTT and the second-order solvers get the spans only, as in
  the reference.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..datasets.dataset import DataSet, ListDataSetIterator
from ..datasets.prefetch import (BatchWindow, DevicePrefetchIterator,
                                 iter_windows, skip_batches)
from ..nn.tape import collect_state, commit_state
from ..telemetry import device_memory_gauges, get_registry, memprof, span
from ..telemetry.perf import StepAccounting, accounting_enabled, \
    get_cost_index
from ..telemetry.slo import get_training_watch, training_health_vec
from ..telemetry.tracecontext import (current_trace_context,
                                      new_trace_context, use_trace_context)
from .step_graph import WindowGraphs, feed_signature


def _descend(net, loss, it: torch.Tensor, health: bool = False):
    """Gradients of ``loss`` with respect to every parameter of a layer
    that is not frozen, then the updater in place at iteration ``it``.
    ``health``: also return ``training_health_vec`` of the loss and the
    gradients, taken before the update (else None)."""
    params = net.param_dicts()
    trainable = [(name, k, p) for name, pd in params.items()
                 if not getattr(net.updater.layer_confs[name], "frozen",
                                False)
                 for k, p in pd.items()]
    gs = torch.autograd.grad(loss, [p for _, _, p in trainable],
                             allow_unused=True)
    grads = {}
    for (name, k, p), g in zip(trainable, gs):
        # a parameter the loss does not use (a VAE's decoder in a
        # supervised stack) has a zero gradient, as in the reference
        grads.setdefault(name, {})[k] = torch.zeros_like(p) if g is None \
            else g
    vec = training_health_vec(loss, grads) if health else None
    net.updater.update(grads, net.opt_state, params, it)
    return vec


def train_step_math(net, x, y, lmask=None, fmask=None, *,
                    gen: Optional[torch.Generator] = None,
                    it: torch.Tensor, with_health: bool = False):
    """The single-step update every SGD path runs: the loss at the current
    parameters, then ``_descend`` at the iteration tensor ``it``, then the
    forward's new layer state into the layers. Returns the loss
    (detached), or (loss, health [3]) with ``with_health``."""
    with collect_state({}) as new_state:
        loss = net.loss_fn(x, y, train=True, gen=gen, labels_mask=lmask,
                           features_mask=fmask)
    vec = _descend(net, loss, it, with_health)
    commit_state(new_state)
    return (loss.detach(), vec) if with_health else loss.detach()


def tbptt_step_math(net, x, y, lmask, fmask, rnn_states, *,
                    gen: Optional[torch.Generator] = None,
                    it: torch.Tensor):
    """One tBPTT chunk: the loss from the carried ``rnn_states`` (None on
    the first chunk: zero states), then ``_descend``. Returns the loss and
    each recurrent layer's final (h, c), both detached."""
    with collect_state({}) as new_state:
        loss, rnn_out = net.loss_fn(
            x, y, train=True, gen=gen, labels_mask=lmask,
            features_mask=fmask, rnn_states=rnn_states,
            collect_rnn_states=True)
    _descend(net, loss, it)
    commit_state(new_state)
    carry = [None if s is None else tuple(v.detach() for v in s)
             for s in rnn_out]
    return loss.detach(), carry


def check_listeners(listeners) -> list:
    """The listeners ``set_listeners`` takes: each has
    ``iteration_done(net, iteration, loss)`` (a ``TrainingListener``, or a
    bare score callback); the epoch hooks and ``note_window`` /
    ``note_batch`` are called where a listener has them."""
    for lis in listeners:
        if not hasattr(lis, "iteration_done"):
            raise TypeError(f"{type(lis).__name__} has no "
                            f"iteration_done(net, iteration, loss)")
    return list(listeners)


def epoch_hook(listeners, hook: str, net) -> None:
    """``on_epoch_start`` / ``on_epoch_end`` on every listener that has
    it."""
    for lis in listeners:
        fn = getattr(lis, hook, None)
        if fn is not None:
            fn(net)


def notify_batch(net, ds, loss, etl_ms: float = 0.0,
                 device_ms: float = 0.0, done: Optional[int] = None) -> None:
    """One batch's fan-out: ``note_batch`` on every listener that has it
    (``PerformanceListener``), then ``iteration_done`` at ``done`` (by
    default the count, before it moves past the batch)."""
    for lis in net.listeners:
        fn = getattr(lis, "note_batch", None)
        if fn is not None:
            fn(ds.num_examples(), etl_wait_ms=etl_ms, device_ms=device_ms)
    it = net.iteration_count if done is None else done
    for lis in net.listeners:
        lis.iteration_done(net, it, loss)


def notify_window(net, datasets, losses, etl_ms: float = 0.0,
                  device_ms: float = 0.0) -> None:
    """A window's fan-out after it ran: ``note_window(k)`` on every
    listener that has it, then ``notify_batch`` a batch with an equal share
    of the window's wait and device time, the count moving past each.
    ``losses[i]`` is batch i's (a device slice: no host read)."""
    k = len(datasets)
    for lis in net.listeners:
        fn = getattr(lis, "note_window", None)
        if fn is not None:
            fn(k)
    for ds, loss in zip(datasets, losses):
        notify_batch(net, ds, loss, etl_ms / k, device_ms / k)
        net.iteration_count += 1


class EtlClock:
    """The input pipeline's wait and the rest of each dispatch's wall time,
    as the reference's fit loop measures them (``optimize/solver.py``
    ``:381-392, 431-441, 556-569``): with a prefetcher, the growth of its
    ``total_wait_ms`` (the time the loop blocked for a batch); without one,
    the time since the last dispatch ended."""

    def __init__(self, prefetcher):
        self.prefetcher = prefetcher
        self.t0 = time.perf_counter()
        self.prev = 0.0

    def skipped(self) -> None:
        """After a resume's skipped batches: they are not this epoch's
        wait."""
        self.t0 = time.perf_counter()
        if self.prefetcher is not None:
            self.prev = self.prefetcher.total_wait_ms

    def etl_ms(self) -> float:
        if self.prefetcher is not None:
            ms = self.prefetcher.total_wait_ms - self.prev
            self.prev = self.prefetcher.total_wait_ms
            return ms
        return (time.perf_counter() - self.t0) * 1e3

    def device_ms(self, etl_ms: float) -> float:
        return max((time.perf_counter() - self.t0) * 1e3 - etl_ms, 0.0)

    def restart(self) -> None:
        self.t0 = time.perf_counter()


def _is_multi(x) -> bool:
    """True for MultiDataSet-style lists of per-input arrays (a plain
    nested list of numbers is single-input data)."""
    return (isinstance(x, (list, tuple)) and len(x) > 0
            and isinstance(x[0], (np.ndarray, torch.Tensor)))


def cast_feed(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The feed-boundary cast: onto ``device`` (a tensor already there is
    not copied); integer arrays (token ids) keep their type, everything
    else takes ``dtype``."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    keep = not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)
    return t.to(device=device, dtype=None if keep else dtype)


def cast_any(x, dtype: torch.dtype, device: torch.device):
    """``cast_feed`` of one array or of a list of them (a MultiDataSet's
    features, labels or masks; None entries stay None)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [None if v is None else cast_feed(v, dtype, device)
                for v in x]
    return cast_feed(x, dtype, device)


def _pretrain_step(layer, rule, opt_state, feed, gen, it) -> torch.Tensor:
    """One update of ``layer``'s parameters on its ``pretrain_loss`` at
    ``feed``: its own rule at iteration ``it`` (a 0-dim tensor) with the
    rule's base learning rate, in place. Returns the loss (detached)."""
    params = layer.param_dict()
    names = list(params)
    loss = layer.pretrain_loss(feed, gen)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True)
    lr = rule.lr(it)
    with torch.no_grad():
        for k, g in zip(names, grads):
            p = params[k]
            upd, opt_state[k] = rule.update_one(
                torch.zeros_like(p) if g is None else g, opt_state[k], lr, it)
            p.sub_(upd.to(p.dtype))
    return loss.detach()


class Solver:
    def __init__(self, net):
        self.net = net
        self._gen: Optional[torch.Generator] = None
        self._it: Optional[torch.Tensor] = None
        # per fit: whether steps return their health vector (a watch is
        # armed), and the cost entry an eager step is counted into
        self._health = False
        self._cost: Optional[tuple] = None
        self._windows = WindowGraphs(
            net, self._step, lambda f: train_step_math(
                net, *f, gen=self._gen, it=self._it,
                with_health=self._health),
            self._at, lambda: self._gen)
        # the last fit's DevicePrefetchIterator (its waits), or None
        self.prefetcher: Optional[DevicePrefetchIterator] = None

    # -------------------------------------------------------- the step
    def _at(self, it: int) -> torch.Tensor:
        """Set the dropout generator's seed and the iteration tensor for
        iteration ``it``; returns the tensor."""
        net = self.net
        if self._gen is None:
            self._gen = torch.Generator(device=net.device)
            self._it = torch.zeros((), dtype=torch.int64, device=net.device)
        self._gen.manual_seed(((net.conf.seed + 7919) << 32) + it)
        self._it.fill_(it)
        return self._it

    def _feed(self, ds):
        """A batch's (x, y, labels mask, features mask) on the device."""
        net = self.net
        return [cast_any(v, net.dtype, net.device)
                for v in (ds.features, ds.labels, ds.labels_mask,
                          ds.features_mask)]

    def _step(self, feed, it: int):
        """One eager step at iteration ``it``; returns its loss (and its
        health vector when a watch is armed). The first step of a shape
        is counted into ``self._cost``'s entry when there is one."""
        it_t = self._at(it)
        net = self.net

        def run():
            return train_step_math(net, *feed, gen=self._gen, it=it_t,
                                   with_health=self._health)
        if self._cost is None:
            return run()
        path, k, timing = self._cost
        return get_cost_index().count(
            path, (id(self), k, feed_signature(feed)), run,
            steps_per_call=k, timing_metric=timing,
            dtype=getattr(net.conf, "compute_dtype", None) or net.dtype,
            device=net.device)

    # ------------------------------------------------------------- fit
    def fit(self, data=None, labels=None, *, epochs=1, batch_size=None,
            iterator=None, dataset=None, async_prefetch: bool = True,
            prefetch_depth: int = 2, steps_per_dispatch: int = 1,
            skip_first_batches: int = 0):
        net = self.net
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if skip_first_batches < 0:
            raise ValueError("skip_first_batches must be >= 0")
        if not net.initialized:
            net.init()
        if iterator is None:
            if dataset is not None:
                iterator = ListDataSetIterator([dataset])
            elif _is_multi(data) or _is_multi(labels):
                # multi-input / multi-output: one batch, fed whole
                iterator = ListDataSetIterator([DataSet(data, labels)])
            else:
                if not isinstance(data, torch.Tensor):
                    data = np.asarray(data)
                if not isinstance(labels, torch.Tensor):
                    labels = np.asarray(labels)
                iterator = ListDataSetIterator(
                    features=data, labels=labels,
                    batch_size=batch_size or data.shape[0])
        if isinstance(iterator, DevicePrefetchIterator):
            feed = iterator
        elif async_prefetch and prefetch_depth >= 1:
            feed = DevicePrefetchIterator(iterator, prefetch_depth,
                                          device=net.device, dtype=net.dtype)
        else:       # prefetch_depth < 1 opts out, as async_prefetch=False
            feed = iterator
        self.prefetcher = (feed if isinstance(feed, DevicePrefetchIterator)
                           else None)
        tbptt = getattr(net.conf, "backprop_type", "standard") == "tbptt"
        second_order = self._second_order_solver(tbptt)
        # tBPTT and the second-order solvers run per step
        k = 1 if tbptt or second_order else steps_per_dispatch
        reg = get_registry()
        # the training watch: SGD paths only (tBPTT and the second-order
        # solvers keep their own step structure, as in the reference)
        watch = None if tbptt or second_order is not None \
            else get_training_watch()
        self._health = watch is not None
        if reg.enabled:
            # memory-profiler owners: metadata only, no device read
            if getattr(net, "opt_state", None) is not None:
                memprof.tag(net.opt_state, "opt_state")
            memprof.tag(net.param_dicts(), "params")
        ctx = current_trace_context()
        with use_trace_context(ctx if ctx is not None
                               else new_trace_context()):
            with span("fit", epochs=epochs, steps_per_dispatch=k,
                      net=type(net).__name__):
                for epoch in range(epochs):
                    with span("epoch", index=epoch):
                        self._fit_epoch(feed, iterator, k, tbptt,
                                        skip_first_batches if epoch == 0
                                        else 0, second_order, reg, watch)
        if watch is not None:
            watch.flush()          # the end of a fit is a window boundary
        return net

    def _second_order_solver(self, tbptt: bool):
        """The configuration's second-order solver (made once), or None
        for "sgd"."""
        conf = self.net.conf
        algo = str(getattr(conf, "optimization_algorithm", "sgd")).lower()
        if algo in ("sgd", "stochastic_gradient_descent"):
            return None
        if tbptt:
            raise ValueError("tBPTT is an SGD-path feature; second-order "
                             "solvers run full-sequence batches")
        if getattr(self, "_second_order", None) is None:
            from .second_order import make_optimizer
            self._second_order = make_optimizer(
                algo, self.net,
                getattr(conf, "max_num_line_search_iterations", 5))
        return self._second_order

    def _fit_epoch(self, feed, iterator, k: int, tbptt: bool,
                   skip: int, second_order=None, reg=None,
                   watch=None) -> None:
        net = self.net
        reg = reg or get_registry()
        epoch_hook(net.listeners, "on_epoch_start", net)
        clock = EtlClock(self.prefetcher)
        # step accounting and cost counting: SGD paths only, as the watch
        acct = None
        if reg.enabled and not tbptt and second_order is None \
                and accounting_enabled():
            acct = StepAccounting(reg)
        # the Solver's own window timing: the window cost entry pairs with
        # it (ParallelWrapper's dispatch spans feed span.dispatch_ms)
        h_disp = reg.histogram("perf.fit.dispatch_ms") if acct else None
        c_iters = reg.counter("train.iterations")
        c_windows = reg.counter("train.windows")
        # the mid-epoch resume: the first ``skip`` batches were trained by
        # the run that wrote the checkpoint (iteration_count covers them),
        # so they are consumed here, before windowing
        src = skip_batches(feed, skip) if skip else iter(feed)
        if skip:
            clock.skipped()
        for item in (iter_windows(src, k) if k > 1 else src):
            etl_ms = clock.etl_ms()
            if isinstance(item, BatchWindow):
                kw = len(item.datasets)
                with span("window", k=kw, iteration=net.iteration_count):
                    feeds = [self._feed(ds) for ds in item.datasets]
                    it0 = net.iteration_count
                    self._cost = (("fit/epoch/window", kw,
                                   "perf.fit.dispatch_ms") if acct else None)
                    t_d0 = time.perf_counter()
                    with span("dispatch", k=kw):
                        out = self._windows.run(feeds, key=(self._health,))
                    dispatch_ms = (time.perf_counter() - t_d0) * 1e3
                    self._cost = None
                    if h_disp is not None:
                        h_disp.observe(dispatch_ms)
                    losses = out
                    if self._health:
                        # [K, 3] device rows: appended, never read here
                        losses, health = out
                        watch.on_health(it0, health, kw)
                    c_windows.inc()
                    c_iters.inc(kw)
                    notify_window(net, item.datasets, losses, etl_ms,
                                  clock.device_ms(etl_ms))
                if acct is not None:
                    wall_ms = (time.perf_counter() - clock.t0) * 1e3
                    acct.on_step(input_wait_ms=etl_ms, compute_ms=dispatch_ms,
                                 host_ms=wall_ms - etl_ms - dispatch_ms,
                                 steps=kw)
                clock.restart()
                continue
            dispatch_ms = None
            # one span a single-step iteration: the step is the dispatch
            with span("step", iteration=net.iteration_count):
                x, y, lmask, fmask = self._feed(item)
                if second_order is not None:
                    loss = second_order.step(x, y, lmask, fmask)
                elif tbptt:
                    loss = self._fit_tbptt_batch(x, y, lmask, fmask)
                else:
                    self._cost = (("fit/epoch/step", 1,
                                   "perf.step.compute_ms") if acct else None)
                    t_d0 = time.perf_counter()
                    loss = self._step([x, y, lmask, fmask],
                                      net.iteration_count)
                    dispatch_ms = (time.perf_counter() - t_d0) * 1e3
                    self._cost = None
                    if self._health:
                        loss, health = loss
                        watch.on_health(net.iteration_count, health, 1)
                c_iters.inc()
                # the listeners see the last iteration run, before the
                # count moves past it, as the reference's (a tBPTT batch
                # has moved it once a chunk already)
                notify_batch(net, item, loss, etl_ms,
                             clock.device_ms(etl_ms),
                             done=net.iteration_count - 1 if tbptt else None)
                if not tbptt:
                    net.iteration_count += 1
            if acct is not None and dispatch_ms is not None:
                wall_ms = (time.perf_counter() - clock.t0) * 1e3
                acct.on_step(input_wait_ms=etl_ms, compute_ms=dispatch_ms,
                             host_ms=wall_ms - etl_ms - dispatch_ms)
            clock.restart()
        epoch_hook(net.listeners, "on_epoch_end", net)
        if reg.enabled:
            # the card's allocator counters, once an epoch (a host read)
            device_memory_gauges(reg)
        if acct is not None:
            # the epoch boundary: flush the decomposition, fold the costs
            # against their timings (host arithmetic, off the loop)
            acct.flush()
            get_cost_index().fold(reg)
        if hasattr(iterator, "reset"):
            iterator.reset()

    def graph_stats(self) -> dict:
        """The window graphs' captures and replays so far, released graphs
        included, and each counted kernel's launches made by replays
        (``WindowGraphs.stats``)."""
        return self._windows.stats()

    # ------------------------------------------------------------ tBPTT
    def _fit_tbptt_batch(self, x, y, lmask, fmask):
        """Chunked tBPTT over the time axis for one network input and label
        or a list of them (a graph's): [B,T,F] time series and [B,T] masks
        are cut into chunks of ``tbptt_fwd_length`` steps, one iteration
        each; static 2-D arrays feed every chunk whole. Returns the last
        chunk's loss."""
        net = self.net
        seqs = lambda v: [u for u in (v if isinstance(v, list) else [v])
                          if u is not None and u.dim() == 3]
        time_lens = {v.shape[1] for v in seqs(x) + seqs(y)}
        if not time_lens:
            raise ValueError("tBPTT requires a [B,T,F] time-series input or "
                             "label")
        if len(time_lens) > 1:
            raise ValueError(f"tBPTT requires the time-series inputs and "
                             f"labels to share one sequence length, got "
                             f"{sorted(time_lens)}")
        T = time_lens.pop()
        k = net.conf.tbptt_fwd_length

        def cut3(v, t0, t1):
            if isinstance(v, list):
                return [cut3(u, t0, t1) for u in v]
            return v[:, t0:t1] if v is not None and v.dim() == 3 else v

        def cut2(m, t0, t1):
            if isinstance(m, list):
                return [cut2(u, t0, t1) for u in m]
            return m[:, t0:t1] if m is not None and m.dim() == 2 else m

        rnn_states, loss = None, None
        for t0 in range(0, T, k):
            t1 = min(t0 + k, T)
            it = self._at(net.iteration_count)
            loss, rnn_states = tbptt_step_math(
                net, cut3(x, t0, t1), cut3(y, t0, t1), cut2(lmask, t0, t1),
                cut2(fmask, t0, t1), rnn_states, gen=self._gen, it=it)
            net.iteration_count += 1
        return loss

    # -------------------------------------------------------- pretrain
    def pretrain(self, iterator, epochs: int = 1):
        """Layerwise unsupervised pretraining: each layer (a graph's layer
        vertex) with a ``pretrain_loss``, in order, takes ``epochs`` passes
        over ``iterator``, fed through the earlier layers without a
        gradient, with its own updater state and its iteration from 0."""
        net = self.net
        if not net.initialized:
            net.init()
        graph = hasattr(net, "vertex_names")
        keys = net.vertex_names if graph else range(len(net.layers))
        gen = torch.Generator(device=net.device)
        it = torch.zeros((), dtype=torch.int64, device=net.device)
        base = (net.conf.seed + 104729) << 32
        for idx, key in enumerate(keys):
            layer = (getattr(net.vertices[key], "layer", None) if graph
                     else net.layers[key])
            if not hasattr(layer, "pretrain_loss"):
                continue
            rule = net.updater.rule_for(layer)
            opt_state = {k: rule.init_one(p.detach())
                         for k, p in layer.param_dict().items()}
            count = 0
            for _ in range(epochs):
                for ds in iterator:
                    feats = (cast_any(ds.features, net.dtype, net.device)
                             if graph else cast_feed(ds.features, net.dtype,
                                                     net.device))
                    with torch.no_grad():
                        feed = self._pretrain_feed(key, idx, feats)
                    gen.manual_seed(base + count * 1000 + idx)
                    it.fill_(count)
                    _pretrain_step(layer, rule, opt_state, feed, gen, it)
                    count += 1
                if hasattr(iterator, "reset"):
                    iterator.reset()
        return net

    def _pretrain_feed(self, key, idx: int, feats):
        """What layer ``key`` (index ``idx``) is pretrained on: the data
        through the layers before it, then its preprocessor."""
        net = self.net
        if hasattr(net, "vertex_names"):
            feats = feats if isinstance(feats, list) else [feats]
            in_name = net.conf.vertex_inputs[key][0]
            if in_name in net.conf.network_inputs:
                feed = feats[net.conf.network_inputs.index(in_name)]
            else:
                feed = net.apply_fn(feats, train=False)[in_name]
            pre = getattr(net.vertices[key], "preprocessor", None)
        else:
            feed = (feats if idx == 0
                    else net.apply_fn(feats, train=False,
                                      to_layer=idx - 1)[-1])
            pre = net.conf.preprocessor(idx)
        return feed if pre is None else pre.apply(feed)
