"""Per-thread tapes of a forward: the dropout masks it drew and the new
layer state it computed.

The reference's layers are pure functions: its remat recomputes a
layer's output from the same key, and its ``apply`` returns the new
state, which ``train_step_math`` carries. The port's layers draw dropout
masks from an explicit generator and hold their state in buffers, so
what a forward drew or computed is kept here:

- ``dropout_masks`` / ``taped``: gradient checkpointing's recompute
  replays the first forward's random draws (dropout masks, a denoising
  autoencoder's corruption, a VAE's or RBM's noise; ``nn/multilayer.py``
  ``run_layer``); ``torch.utils.checkpoint`` restores only the global
  generators;
- ``collect_state`` / ``record_state`` / ``commit_state``: a training
  forward hands its new layer state (a BatchNormalization's running
  statistics) to the enclosing sink, and the step writes it into the
  layers' buffers once. A replayed forward records nothing, and a forward
  outside a sink (``output(train=True)``) drops it, as the reference's
  does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List

import torch

_tape = threading.local()


def mask_tape():
    """This thread's dropout tape: (masks, replay, [next index]) inside a
    ``dropout_masks`` block, else None."""
    return getattr(_tape, "state", None)


@contextlib.contextmanager
def dropout_masks(masks: List[torch.Tensor], replay: bool):
    """Within the block, the dropout masks this thread draws are appended
    to ``masks`` (``replay`` False) or, with ``replay``, taken from it in
    order instead of drawn. Gradient checkpointing's recompute replays the
    first forward's masks this way (``nn/multilayer.py`` ``run_layer``):
    ``torch.utils.checkpoint`` restores only the global generators, not
    the explicit one dropout draws from."""
    prev = mask_tape()
    _tape.state = (masks, replay, [0])
    try:
        yield
    finally:
        _tape.state = prev


def taped(draw):
    """``draw()``, a random draw of a layer's forward, through this
    thread's tape: inside a ``dropout_masks`` block it is recorded, or in
    a replay the recorded draw is returned in its place; outside one it is
    ``draw()``."""
    tape = mask_tape()
    if tape is not None and tape[1]:
        masks, _, at = tape
        at[0] += 1
        return masks[at[0] - 1]
    out = draw()
    if tape is not None:
        tape[0].append(out)
    return out


@contextlib.contextmanager
def collect_state(sink: dict):
    """Within the block, the new layer state that this thread's training
    forwards compute is put into ``sink``: {layer: {state name: tensor}}
    (``record_state``)."""
    prev = getattr(_tape, "sink", None)
    _tape.sink = sink
    try:
        yield sink
    finally:
        _tape.sink = prev


def record_state(layer, new_state: dict) -> None:
    """A training forward's new state for ``layer``, into the enclosing
    ``collect_state`` sink; dropped outside one and in a replay of the
    forward (``dropout_masks`` with ``replay``), which recomputes what the
    first run recorded."""
    tape = mask_tape()
    if tape is not None and tape[1]:
        return
    sink = getattr(_tape, "sink", None)
    if sink is not None:
        sink[layer] = new_state


@torch.no_grad()
def commit_state(sink: dict) -> None:
    """Write each recorded new state into its layer's buffers in place
    (the addresses a captured training step binds stay)."""
    for layer, new_state in sink.items():
        for name, value in new_state.items():
            getattr(layer, name).copy_(value)
