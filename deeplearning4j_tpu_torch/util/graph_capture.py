"""Capturing one step into a CUDA graph: the routine the port's graphs share.

The decode step (``serving/generation/graphs.py``) and the training step
(``optimize/step_graph.py``) are each captured once and replayed per token
or per batch. Both go through ``capture``, so they keep one set of rules:

- **One capture at a time in the process.** CUDA allows one stream capture
  at a time per process, so every capture holds the one lock below.
- **No garbage collection during a capture.** A dead network's or
  cohort's graph (its owners hold each other, so only the collector frees
  them) would be reset mid-capture, freeing device memory, which a capture
  forbids; the capture then fails inside whatever runs next (seen as
  ``CUBLAS_STATUS_INTERNAL_ERROR`` in a cuBLAS call on an H100). So pending
  cycles are collected first and the collector is off until the capture
  ends.
- **``thread_local`` mode, on the caller's side stream.** Another thread
  may be using the card (another model's dispatch thread, a prefetcher's
  copies); the caller replays on the thread that captured.
- **The generators are registered** with the graph (one, or a
  data-parallel step's one a worker), so each replay draws from the state
  the caller set before it, as the eager step does.
- **No fallback.** A capture that fails raises with its reason; nothing
  retries eagerly.
- **Launch counts.** A kernel wrapper's ``launches`` counts its Python
  calls. A capture makes those calls without launching, so the counts are
  put back after it, and the capture reports per kernel the launches it
  holds: a kernel then ran its wrapper's count plus that number times the
  graph's replays. (A launch of the same kernel by another thread during
  the capture would be counted as captured.)
- **Telemetry.** A finished capture is noted to
  ``telemetry.note_capture`` (the port's counterpart of a compile event),
  after the capture ends.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

import torch

from ..telemetry.torchsignals import note_capture

# CUDA allows one stream capture at a time per process
_lock = threading.Lock()


@contextlib.contextmanager
def _no_collection():
    """Collect pending cycles, then keep the collector off (see the module
    docstring)."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def capture(graph: torch.cuda.CUDAGraph, fn: Callable, *,
            stream: torch.cuda.Stream, device: torch.device,
            gen: Union[None, torch.Generator,
                       Sequence[torch.Generator]] = None,
            counted: Mapping[str, object] = (), what: str = "the step"
            ) -> Tuple[object, Dict[str, int]]:
    """Capture ``fn()`` into ``graph`` on ``stream`` (the caller has run
    the step eagerly there once, so lazy per-stream set-up is done).
    ``counted`` maps names to kernel wrappers with a ``launches`` count.
    Returns ``fn``'s output (static tensors the replays overwrite) and the
    launches the capture holds, by name."""
    counted = dict(counted)
    before = {n: w.launches for n, w in counted.items()}
    t0 = time.perf_counter()
    with _lock, torch.cuda.device(device), _no_collection():
        stream.wait_stream(torch.cuda.current_stream(device))
        for g in ([] if gen is None else
                  [gen] if isinstance(gen, torch.Generator) else gen):
            graph.register_generator_state(g)
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except Exception as e:
                try:
                    graph.capture_end()
                except Exception:              # the capture is void anyway
                    pass
                raise RuntimeError(f"capturing {what} failed: {e}") from e
            try:
                graph.capture_end()
            except Exception as e:
                raise RuntimeError(f"capturing {what} failed: {e}") from e
        torch.cuda.current_stream(device).wait_stream(stream)
    # outside the captured region: the telemetry record allocates nothing
    # on the card, but no host work belongs inside a capture
    note_capture(time.perf_counter() - t0)
    launches = {}
    for n, w in counted.items():
        if w.launches != before[n]:
            launches[n] = w.launches - before[n]
            w.launches -= launches[n]          # captured, not launched
    return out, launches
