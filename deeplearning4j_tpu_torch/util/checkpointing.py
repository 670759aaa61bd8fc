"""Checkpoint directories: the read side.

Counterpart of ``deeplearning4j_tpu/util/checkpointing.py`` (``:28``,
``:134-189``): the checkpoint name pattern, listing a directory's
checkpoints in (epoch, step) order, structural validation of a zip, its
manifest, and ``latest_checkpoint``, the newest VALID checkpoint (a
truncated newest zip falls back to the one before it). Serving's
``load_net`` reads a checkpoint directory through it.

The write side needs the training listeners: ``CheckpointListener`` and
``ProfilerListener`` need ``optimize/listeners.py`` (ROADMAP A8), and so
does ``fit_with_checkpointing``, which writes through
``CheckpointListener`` (the mid-epoch resume it drives,
``skip_first_batches``, is ported). They raise ``NotImplementedError``
naming their item.
"""
from __future__ import annotations

import json
import logging
import os
import re
import zipfile
from typing import List, Optional

from .serialization import MANIFEST_ENTRY

_log = logging.getLogger("deeplearning4j_tpu_torch")

# boundary saves: checkpoint_epoch{E}.zip        (E epochs fully done)
# mid-epoch saves: checkpoint_epoch{E}_step{S}.zip (E done + S steps into
# epoch E+1) — sort key (E, S), boundary == (E, 0)
_CKPT_RE = re.compile(r"^checkpoint_epoch(\d+)(?:_step(\d+))?\.zip$")


def _scan_checkpoints(directory: str) -> List[tuple]:
    """[(path, (epoch, step))] sorted ascending by (epoch, step)."""
    out = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append((os.path.join(directory, name),
                            (int(m.group(1)), int(m.group(2) or 0))))
    return sorted(out, key=lambda t: t[1])


def list_checkpoints(directory: str) -> List[tuple]:
    """[(path, epoch)] sorted ascending by (epoch, step-within-epoch)."""
    return [(path, key[0]) for path, key in _scan_checkpoints(directory)]


def is_valid_checkpoint(path: str) -> bool:
    """Cheap structural validation: a readable zip whose manifest (when it
    has one) parses. A truncated copy loses the zip's central directory,
    which ``is_zipfile`` catches without reading the payload."""
    try:
        if not zipfile.is_zipfile(path):
            return False
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            if MANIFEST_ENTRY in names:
                json.loads(z.read(MANIFEST_ENTRY).decode())
            return bool(names)
    except Exception:
        return False


def read_checkpoint_manifest(path: str) -> dict:
    """The manifest dict of a checkpoint zip ({} if absent or foreign)."""
    try:
        with zipfile.ZipFile(path) as z:
            return json.loads(z.read(MANIFEST_ENTRY).decode())
    except Exception:
        return {}


def latest_checkpoint(directory: str, validate: bool = True) -> Optional[str]:
    """Newest VALID checkpoint: a truncated or corrupt newest entry falls
    back to the previous one (``validate=False`` trusts the newest)."""
    for path, _ in reversed(_scan_checkpoints(directory)):
        if not validate or is_valid_checkpoint(path):
            return path
        _log.warning("checkpoint %s is truncated/corrupt; falling back to "
                     "the previous checkpoint", path)
    return None


class CheckpointListener:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("CheckpointListener needs the training "
                                  "listeners (optimize/listeners.py), which "
                                  "are not ported yet (ROADMAP A8)")


class ProfilerListener:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("ProfilerListener needs the training "
                                  "listeners and telemetry, which are not "
                                  "ported yet (ROADMAP A8)")


def fit_with_checkpointing(net, iterator, **kwargs):
    raise NotImplementedError("fit_with_checkpointing (the resumable "
                              "training loop) writes through "
                              "CheckpointListener, which needs the training "
                              "listeners: not ported yet (ROADMAP A8)")
