"""One training step as a CUDA graph: the body of a K-step window.

Counterpart of the reference's jitted window program
(``deeplearning4j_tpu/optimize/solver.py:117-166``: ``train_step_math``
under ``lax.scan`` over K stacked batches, one dispatch a window). Here the
eager step (``solver.train_step_math``: the loss, ``torch.autograd.grad``,
the in-place updater at the iteration tensor) is captured once into a
``torch.cuda.CUDAGraph`` and replayed once per batch of a window. The
model is ``serving/generation/graphs.py``'s decode graph:

- **What it binds.** The graph holds the addresses it was captured over:
  the network's parameters, layer state (a BatchNormalization's running
  statistics, written in place once a step) and updater state (all
  updated in place, so their addresses stay), the solver's iteration
  tensor and dropout generator, and its own static input buffers. So one
  graph serves one (feed shapes and dtypes, mask presence, compute dtype,
  gradient checkpointing) of one network; ``binding`` fingerprints the
  parameter and state tensors, and the solver captures anew when a
  network's tensors were replaced (``init``, a restore).
- **A step.** The batch (already on the device) is copied into the static
  buffers, the iteration tensor is filled with the step's iteration and
  the dropout generator is reseeded with the step's seed, as the eager step
  does, then the graph is replayed on the current stream. The generator is
  registered with the graph (``register_generator_state``), so a replay
  draws from the seed set before it: the masks equal the eager step's.
- **Capture.** After a warm eager step on the capture stream (the window's
  first batch trains that way: kernels built, their plans cached, cuBLAS
  set up for the stream), through ``util/graph_capture.capture``, the
  routine the decode graph uses too: ``thread_local`` mode, one capture at
  a time in the process, the garbage collector off, no eager retry. The
  CPU has no graphs: there the solver runs a window's steps eagerly.
- **Launch counts.** The capture puts the wrappers' counts back and the
  graph keeps, per kernel, the launches its capture holds (``launches``)
  and its ``replays``: a kernel ran its wrapper's count plus
  ``launches[name] * replays`` times.
- **The feed.** A window holds single-array batches only (multi-input
  batches run per step), so a step's feed is a flat sequence of tensors
  (``Solver``'s ``[x, y, labels mask, features mask]``, a mask None when
  absent; ``ParallelWrapper``'s ``(x, y)``).
- **Windows.** ``WindowGraphs`` is the window runner ``Solver`` and
  ``ParallelWrapper`` share: one graph per key (the feed's signature, the
  trainer's own key fields, the compute dtype and gradient checkpointing),
  recaptured when ``binding`` changed, and the counts ``graph_stats``
  reports.
- **Several outputs.** A step may return a tuple of tensors (the Solver's
  loss and, with a ``TrainingWatch`` armed, its ``[3]`` health vector).
  Each replay overwrites the graph's static outputs, so every replay's are
  copied into the window's ``[K, ...]`` buffers on the loop's stream before
  the next replay; the window returns the tuple of buffers. The health
  vector only reads the gradients, so the parameters are the same bits
  with it or without it.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..ops import flash_attention as fa
from ..ops import lstm
from ..util.graph_capture import capture

# the kernel wrappers a training step may call, by the names the launch
# checks use
COUNTED = {"flash_attention_fwd": fa.flash_attention,
           "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
           "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
           "lstm_fwd": lstm.fused_lstm_fwd,
           "lstm_bwd": lstm.fused_lstm_bwd}


def feed_signature(feed: Sequence) -> tuple:
    """(shape, dtype) of each tensor of a step's feed (x, y, labels mask,
    features mask; a multi-input graph's lists nest), None for an absent
    one."""
    return tuple(None if t is None
                 else feed_signature(t) if isinstance(t, (list, tuple))
                 else (tuple(t.shape), t.dtype) for t in feed)


def _tensors(tree):
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def binding(net) -> tuple:
    """The addresses of the network's parameters, layer state and updater
    state (the per-layer format or the ZeRO sharded one), which a captured
    step reads and writes."""
    ptrs = [p.data_ptr() for pd in net.param_dicts().values()
            for p in pd.values()]
    ptrs += [t.data_ptr() for sd in net.state_dicts().values()
             for t in sd.values()]
    ptrs += [s.data_ptr() for s in _tensors(net.opt_state)]
    return tuple(ptrs)


class TrainStepGraph:
    """One training step as a CUDA graph (see the module docstring).
    ``step(feed)`` is the eager step on a feed of tensors; it is captured
    over static copies of ``feed``'s tensors on ``stream``, after the
    caller's warm eager step there. ``gen``: the generator the step draws
    dropout from, or a sequence of them (``ParallelWrapper``'s, one a
    worker)."""

    def __init__(self, net, feed: Sequence, step: Callable,
                 gen, stream: torch.cuda.Stream):
        if net.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{net.device}")
        self.signature = feed_signature(feed)
        self.binding = binding(net)
        self._static = [None if t is None else t.clone() for t in feed]
        self.replays = 0
        self.graph = torch.cuda.CUDAGraph()
        self._loss, self.launches = capture(
            self.graph, lambda: step(self._static), stream=stream,
            device=net.device, gen=gen, counted=COUNTED,
            what="the training step")

    def run(self, feed) -> torch.Tensor:
        """Copy ``feed`` into the static buffers and replay on the current
        stream; returns the step's output (static tensors, overwritten by
        the next replay). The caller has set the iteration tensor and the
        generator's seed."""
        for s, t in zip(self._static, feed):
            if s is not None:
                s.copy_(t)
        self.graph.replay()
        self.replays += 1
        return self._loss

    def release(self) -> None:
        """Free the graph and its private memory pool (its counts stay)."""
        self.graph.reset()
        self._loss = None
        self._static = None


class WindowGraphs:
    """The K steps of a window, as replays of one captured step on the
    card and eagerly on the CPU (see the module docstring). The trainer
    gives ``warm(feed, it)``, its eager step at iteration ``it``;
    ``step(feed)``, the step to capture, which reads the iteration tensor
    and generators that ``at(it)`` fills; and ``gens()``, the generators
    to register with a graph (made by the first ``at``)."""

    def __init__(self, net, warm: Callable, step: Callable, at: Callable,
                 gens: Callable):
        self.net = net
        self._warm, self._step, self._at, self._gens = warm, step, at, gens
        self.graphs = {}               # key -> TrainStepGraph
        self._made = []                # every graph made (released ones too)

    def run(self, feeds, key: Tuple = ()) -> torch.Tensor:
        """Run the window's steps from iteration ``net.iteration_count`` on
        (without advancing it); returns their losses [K] (a tuple of [K,
        ...] buffers when the step returns a tuple). ``key``: the
        trainer's fields that change the captured step. On the card the
        window's first step runs eagerly on a capture stream of its own
        (as the decode graph's) when this key has no graph yet, and is
        then captured."""
        net = self.net
        it0 = net.iteration_count
        if net.device.type != "cuda":
            outs = [self._warm(feed, it0 + i) for i, feed in enumerate(feeds)]
            if isinstance(outs[0], tuple):
                return tuple(torch.stack(col) for col in zip(*outs))
            return torch.stack(outs)
        key = feed_signature(feeds[0]) + tuple(key) + (
            getattr(net.conf, "compute_dtype", None),
            bool(getattr(net.conf, "gradient_checkpointing", False)))
        graph = self.graphs.get(key)
        if graph is not None and graph.binding != binding(net):
            graph.release()           # the network's tensors were replaced
            graph = None
        out, start = None, 0
        if graph is None:
            side = torch.cuda.Stream(device=net.device)
            cur = torch.cuda.current_stream(net.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):      # the warm step: step 0
                first = self._warm(feeds[0], it0)
            cur.wait_stream(side)
            out = _buffers(first, len(feeds))
            _put(out, 0, first)
            graph = TrainStepGraph(net, feeds[1], self._step, self._gens(),
                                   side)
            self.graphs[key] = graph
            self._made.append(graph)
            start = 1
        for i in range(start, len(feeds)):
            self._at(it0 + i)
            res = graph.run(feeds[i])
            if out is None:
                out = _buffers(res, len(feeds))
            _put(out, i, res)       # before the next replay overwrites res
        return out

    def stats(self) -> dict:
        """The graphs' captures and replays so far, released graphs
        included, and each counted kernel's launches made by replays (its
        captured launches times the replays)."""
        launches = {}
        for g in self._made:
            for name, n in g.launches.items():
                launches[name] = launches.get(name, 0) + n * g.replays
        return {"captures": len(self._made),
                "replays": sum(g.replays for g in self._made),
                "launches_in_replays": launches}


def _buffers(res, k: int):
    """[k, ...] buffers for a step's output (a tensor or a tuple)."""
    if isinstance(res, tuple):
        return tuple(_buffers(t, k) for t in res)
    return torch.empty((k,) + tuple(res.shape), dtype=res.dtype,
                       device=res.device)


def _put(out, i: int, res) -> None:
    """Row ``i`` of the window's buffers := a step's output."""
    if isinstance(res, tuple):
        for o, t in zip(out, res):
            o[i].copy_(t)
    else:
        out[i].copy_(res)
