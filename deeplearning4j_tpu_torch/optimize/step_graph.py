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
  batches run per step), so a step's feed is the flat ``[x, y, labels
  mask, features mask]``, a mask None when absent.
"""
from __future__ import annotations

from typing import Callable, Sequence

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
    features mask), None for an absent one."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in feed)


def binding(net) -> tuple:
    """The addresses of the network's parameters, layer state and updater
    state, which a captured step reads and writes."""
    ptrs = [p.data_ptr() for pd in net.param_dicts().values()
            for p in pd.values()]
    ptrs += [t.data_ptr() for sd in net.state_dicts().values()
             for t in sd.values()]
    ptrs += [s.data_ptr() for layer in net.opt_state.values()
             for st in layer.values() for s in st.values()]
    return tuple(ptrs)


class TrainStepGraph:
    """One training step as a CUDA graph (see the module docstring).
    ``step(feed)`` is the eager step on a feed of tensors; it is captured
    over static copies of ``feed``'s tensors on ``stream``, after the
    caller's warm eager step there."""

    def __init__(self, net, feed: Sequence, step: Callable,
                 gen: torch.Generator, stream: torch.cuda.Stream):
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
        stream; returns the step's loss (a static tensor, overwritten by
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
