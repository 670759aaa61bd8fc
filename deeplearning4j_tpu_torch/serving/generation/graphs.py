"""A CUDA graph of one cohort's decode step.

Counterpart of the reference's ahead-of-time decode executable
(``deeplearning4j_tpu/serving/generation/programs.py:495-497``: the decode
step lowered and compiled once at warm-up, then dispatched once per token
with no tracing). Here the eager decode step (``GenerationProgramSet.
decode_tensors``: embed, every block or LSTM layer with its K5 launch, the
K/V store's scatter and gather, and sampling) is captured once into a
``torch.cuda.CUDAGraph`` and replayed once per token.

- **What it binds.** A graph holds the device addresses it was captured
  over: the cohort's cache (pools or recurrent states), the program set's
  weights and its own static input buffers. So each cohort of each model
  has its own graph; a hot swap's new cohort captures a new one, and a
  drained cohort's graph is released with its pools.
- **Inputs and outputs.** ``tokens``, ``pos``, ``tables``, ``active``,
  ``temp`` and ``topk`` are copied from pinned host arrays into the
  static device buffers, the graph is replayed on the current stream, and
  the next tokens come back through one pinned copy.
- **Capture.** On the cohort's dispatch thread, after ``warm()`` (the
  kernels are built and their plans cached, so no plan query or build runs
  inside the capture): one eager run on the capture stream (lazy
  per-thread and per-stream set-up, such as cuBLAS's, happens there), then
  the capture, in ``thread_local`` mode because another model's dispatch
  thread may be using the card, one capture at a time in the process. The
  sampling generator is registered with the graph, so each replay draws
  fresh numbers from it, as the eager step does.
- **No fallback.** A capture that fails (a kernel whose C entry refuses
  inside it, its 720 included) raises with its reason; nothing retries
  eagerly. The CPU has no graphs: a cohort on the CPU runs the eager step,
  which is the tests' path.
- **Launch counts.** A kernel wrapper's ``launches`` counts its Python
  calls, and a replay makes none. The graph records, per kernel, the
  launches its capture enqueued (``launches``) and the number of
  ``replays``, so a caller counts a kernel's runs as the wrapper's count
  plus ``launches[name] * replays``.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from ...ops import lstm

# the kernel wrappers a decode step calls (the transformer's decode step
# runs none: its attention is the plain one); their ``launches`` counts
# are compared around the capture
_COUNTED = {"lstm_fwd": lstm.fused_lstm_fwd}

# CUDA allows one stream capture at a time per process
_capture_lock = threading.Lock()


class DecodeGraph:
    """One cohort's decode step as a CUDA graph (see the module
    docstring). ``run`` takes the scheduler's numpy arrays and returns the
    next tokens as numpy."""

    def __init__(self, ps, cache, gen: torch.Generator):
        if ps.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{ps.device}")
        if not ps.warmed:
            raise RuntimeError("capture the decode step after warm(): its "
                               "kernels and plans must exist first")
        c = ps.config
        S, mb, dev = c.decode_slots, c.blocks_per_seq, ps.device
        specs = {"tokens": ((S,), torch.int64), "pos": ((S,), torch.int64),
                 "tables": ((S, mb), torch.int64),
                 "active": ((S,), torch.bool),
                 "temp": ((S,), torch.float32), "topk": ((S,), torch.int64)}
        self._dev = {n: torch.zeros(shape, dtype=dt, device=dev)
                     for n, (shape, dt) in specs.items()}
        self._host = {n: torch.zeros(shape, dtype=dt, pin_memory=True)
                      for n, (shape, dt) in specs.items()}
        self._host_np = {n: t.numpy() for n, t in self._host.items()}
        self._out_host = torch.zeros((S,), dtype=torch.int64,
                                     pin_memory=True)
        self._done = torch.cuda.Event()
        self.replays = 0
        self.launches: Dict[str, int] = {}
        self.graph = torch.cuda.CUDAGraph()
        self._capture(ps, cache, gen)

    def _step(self, ps, cache, gen):
        d = self._dev
        return ps.decode_tensors(cache, d["tokens"], d["pos"], d["tables"],
                                 d["active"], gen, d["temp"], d["topk"])

    def _capture(self, ps, cache, gen) -> None:
        side = torch.cuda.Stream(device=ps.device)
        wrappers = _COUNTED
        with _capture_lock, torch.cuda.device(ps.device):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step(ps, cache, gen)     # per-thread/stream set-up
            side.synchronize()
            self.graph.register_generator_state(gen)
            before = {n: w.launches for n, w in wrappers.items()}
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._out = self._step(ps, cache, gen)
                except Exception as e:
                    try:
                        self.graph.capture_end()
                    except Exception:          # the capture is void anyway
                        pass
                    raise RuntimeError(f"capturing the decode step failed: "
                                       f"{e}") from e
                try:
                    self.graph.capture_end()
                except Exception as e:
                    raise RuntimeError(f"capturing the decode step failed: "
                                       f"{e}") from e
            torch.cuda.current_stream().wait_stream(side)
        self.launches = {n: w.launches - before[n]
                         for n, w in wrappers.items()
                         if w.launches != before[n]}

    def run(self, tokens, pos, tables, active, temp, topk) -> np.ndarray:
        """Copy the step's inputs in, replay, and return the next tokens
        [S] (waits for the card)."""
        h = self._host_np
        h["tokens"][:] = tokens
        h["pos"][:] = pos
        h["tables"][:] = tables
        h["active"][:] = active
        h["temp"][:] = temp
        h["topk"][:] = topk
        for name, t in self._dev.items():
            t.copy_(self._host[name], non_blocking=True)
        self.graph.replay()
        self.replays += 1
        self._out_host.copy_(self._out, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return self._out_host.numpy().copy()

    def release(self) -> None:
        """Free the graph and its private memory pool (its counts stay)."""
        self.graph.reset()
        self._out = None
        self._dev = None
