"""Checkpoint directories: periodic checkpoints and the resumable fit.

Counterpart of ``deeplearning4j_tpu/util/checkpointing.py``: the
checkpoint name pattern, listing a directory's checkpoints in (epoch,
step) order, structural validation of a zip, its manifest and
``latest_checkpoint``, the newest VALID checkpoint (``:28, 134-189``);
``CheckpointListener`` (``:31-132``), ``fit_with_checkpointing``
(``:191-248``) and ``ProfilerListener`` (``:251-317``). Serving's
``load_net`` reads a checkpoint directory through the read side.

- **``CheckpointListener``** writes a model zip at epoch boundaries and,
  with ``every_n_iterations=N``, every N steps within an epoch; the
  manifest records ``epochs_done``, ``step_within_epoch`` and
  ``iterations_done``. A write goes to a temporary file renamed into
  place, and pruning to ``keep_last`` touches only checkpoints no newer
  than the last write this listener completed. A mid-epoch save must fall
  on a window's end: inside a K-step window the listeners run after the
  window, so a save there would store the window's end under a step
  inside it, and a resume would train the window's last batches twice.
  The listener learns of each window through ``note_window`` and raises
  rather than write such a save; ``fit_with_checkpointing`` refuses an
  ``every_n_iterations`` that ``steps_per_dispatch`` does not divide
  before it trains. Its zips are stored, not deflated
  (``serialization._write_zip``; the reference deflates them): deflate
  saves ~7 % of a zip of floats at a few tens of MB/s of one core, which
  would make a checkpoint of ``_TLM`` with Adam state (510 MB) take
  ~10-30 s; the entries are the reference's and either package reads
  either zip. A network whose updater state is ZeRO-sharded
  (``ParallelWrapper(zero_stage=...)``) is refused, as by ``write_model``;
  its checkpoints go through ``util/distributed_checkpoint.py``.
- **``fit_with_checkpointing``** restores the newest checkpoint that
  loads (a truncated or corrupt newer one is skipped), trains what is
  left and skips the batches the interrupted epoch had trained
  (``skip_first_batches``). It copies the checkpoint's parameters,
  updater state, iteration count AND layer state (``state.bin``: a
  BatchNormalization's running statistics) into ``net``, in place. The
  reference copies no layer state (``:225-234``), so a network with
  BatchNormalization resumes there with the statistics it had before the
  restore; ROADMAP lists this under the reference's faults and the
  port's deliberate differences.
- **``ProfilerListener``** runs ``torch.profiler`` over a window of
  iterations and writes a Chrome trace into ``log_dir``. A profiler that
  is already active (the process allows one) is logged and the window is
  skipped; the fit goes on. A ``profiler_capture`` span covers the window,
  as the reference's (``:304-305``).
"""
from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import time
import zipfile
from typing import List, Optional, Tuple

import torch

from ..optimize.listeners import TrainingListener
from ..telemetry import span
from .serialization import (MANIFEST_ENTRY, flat_state_order, restore_model,
                            _write_zip)

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


class CheckpointListener(TrainingListener):
    """Writes checkpoints at epoch boundaries (every ``every_n_epochs``) and,
    with ``every_n_iterations=N``, every N steps within an epoch (see the
    module docstring). Keeps the newest ``keep_last``."""

    def __init__(self, directory: str, every_n_epochs: int = 1,
                 keep_last: int = 3, save_updater: bool = True,
                 every_n_iterations: Optional[int] = None):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.every_n_epochs = max(1, every_n_epochs)
        self.keep_last = keep_last
        self.save_updater = save_updater
        self.every_n_iterations = every_n_iterations
        self._epoch = 0
        self._step = 0                      # step within the current epoch
        self._last_completed: Optional[Tuple[int, int]] = None
        self._window_left = 0               # steps of the open window
        self.write_s: List[float] = []      # seconds each write took

    def note_window(self, k: int):
        self._window_left = k

    def iteration_done(self, model, iteration, score):
        self._step += 1
        inside = self._window_left > 1      # a window step, not its last
        self._window_left = max(0, self._window_left - 1)
        if not self.every_n_iterations:
            return
        if self._step % self.every_n_iterations:
            return
        if inside:
            raise ValueError(
                f"a checkpoint is due at step {self._step} of epoch "
                f"{self._epoch}, inside a steps_per_dispatch window whose "
                f"state is its end's: use an every_n_iterations that the "
                f"window size divides, from a window boundary")
        self._write(model, self._epoch, self._step)

    def on_epoch_end(self, model):
        self._epoch += 1
        self._step = 0
        if self._epoch % self.every_n_epochs:
            return
        self._write(model, self._epoch, 0)

    def _write(self, model, epoch: int, step: int):
        name = (f"checkpoint_epoch{epoch}.zip" if step == 0
                else f"checkpoint_epoch{epoch}_step{step}.zip")
        final = os.path.join(self.directory, name)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        # the listeners run before the count moves past the step just run,
        # so a mid-epoch save records count + 1; at an epoch boundary the
        # count has moved already. A resume restores this value, so the
        # iteration tensor and the dropout seeds line up.
        it = getattr(model, "iteration_count", 0)
        t0 = time.perf_counter()
        try:
            _write_zip(model, tmp, self.save_updater, {
                "epochs_done": epoch, "step_within_epoch": step,
                "iterations_done": it + 1 if step else it},
                zipfile.ZIP_STORED)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.write_s.append(time.perf_counter() - t0)
        self._last_completed = (epoch, step)
        self._prune()

    def _prune(self):
        if self._last_completed is None:
            return
        # only checkpoints no newer than the last write this listener
        # completed are candidates: a newer one may be another writer's
        done = [(path, key) for path, key in _scan_checkpoints(self.directory)
                if key <= self._last_completed]
        for path, _ in done[:-self.keep_last]:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass


def _copy_into(net, restored, load_updater: bool) -> None:
    """``restored``'s parameters, layer state and (``load_updater``)
    updater state copied into ``net``'s tensors, in place (a captured step
    keeps its addresses)."""
    from ..parallel.data_parallel import flat_opt_state_order
    with torch.no_grad():
        net.set_params_flat(restored.params_flat())
        for (*_, a), (*_, b) in zip(flat_state_order(net),
                                    flat_state_order(restored)):
            a.copy_(b)
        if load_updater and restored.opt_state is not None:
            for (*_, a), (*_, b) in zip(flat_opt_state_order(net),
                                        flat_opt_state_order(restored)):
                a.copy_(b)


def fit_with_checkpointing(net, iterator, *, epochs: int, checkpoint_dir: str,
                           every_n_epochs: int = 1, keep_last: int = 3,
                           load_updater: bool = True,
                           every_n_iterations: Optional[int] = None,
                           **fit_kw):
    """Resumable training: restores the newest checkpoint in
    ``checkpoint_dir`` that loads (see the module docstring), then trains
    the remaining epochs, checkpointing as it goes, and skips the batches
    of an interrupted epoch that were trained (``step_within_epoch``). A
    checkpoint without that key is an epoch-boundary save. ``fit_kw``
    goes to ``net.fit`` (``steps_per_dispatch``, ``async_prefetch``);
    mid-epoch saves need windows that end on them: ``steps_per_dispatch``
    must divide ``every_n_iterations`` and the resumed step.
    Returns (net, epochs run); a resumed partial epoch counts as one."""
    k = fit_kw.get("steps_per_dispatch", 1)
    if every_n_iterations and every_n_iterations % k:
        raise ValueError(
            f"every_n_iterations={every_n_iterations} is not a multiple of "
            f"steps_per_dispatch={k}: a save would fall inside a window, "
            f"where the state is the window's end")
    done, step_in_epoch = 0, 0
    restored, manifest = None, {}
    for path, key in reversed(_scan_checkpoints(checkpoint_dir)):
        if not is_valid_checkpoint(path):
            _log.warning("checkpoint %s is truncated/corrupt; falling back "
                         "to the previous checkpoint", path)
            continue
        try:
            restored = restore_model(path, load_updater=load_updater,
                                     device=net.device)
        except Exception as e:
            _log.warning("checkpoint %s failed to restore (%s); falling "
                         "back to the previous checkpoint", path, e)
            continue
        manifest = read_checkpoint_manifest(path)
        done = int(manifest.get("epochs_done", key[0]))
        # a missing key is an epoch-boundary save
        step_in_epoch = int(manifest.get("step_within_epoch", 0))
        break
    if every_n_iterations and step_in_epoch % k:
        raise ValueError(
            f"the newest checkpoint is at step {step_in_epoch} of its "
            f"epoch, which is not a window boundary of "
            f"steps_per_dispatch={k}: the windows from there would hold "
            f"the next saves")
    if restored is not None:
        if not net.initialized:
            net.init()
        _copy_into(net, restored, load_updater)
        net.iteration_count = int(manifest.get("iterations_done",
                                               restored.iteration_count))
        del restored
    remaining = max(0, epochs - done)
    if remaining == 0:
        return net, 0
    listener = CheckpointListener(checkpoint_dir, every_n_epochs, keep_last,
                                  every_n_iterations=every_n_iterations)
    listener._epoch = done
    listener._step = step_in_epoch
    saved = list(net.listeners)
    net.set_listeners(*(saved + [listener]))
    try:
        net.fit(iterator=iterator, epochs=remaining,
                skip_first_batches=step_in_epoch, **fit_kw)
    finally:
        net.set_listeners(*saved)
    return net, remaining


class ProfilerListener(TrainingListener):
    """``torch.profiler`` over iterations [``start_iteration``,
    ``start_iteration + n_iterations``); the Chrome trace goes into
    ``log_dir`` (``trace_path`` once written). A profiler already active
    in the process is logged and this window skipped (see the module
    docstring)."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 n_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.end_iteration = start_iteration + n_iterations
        self._active = False
        self._done = False
        self._prof = None
        self._span = None
        self.trace_path: Optional[str] = None

    def _start(self, model) -> None:
        if torch.autograd.profiler._is_profiler_enabled:
            raise RuntimeError("another profiler is active")
        acts = [torch.profiler.ProfilerActivity.CPU]
        device = getattr(model, "device", torch.device("cpu"))
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._prof = prof

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir,
                                f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:      # a failed export must not kill the fit
            _log.warning("ProfilerListener: stopping the trace failed (%s)",
                         e)
        if self._span is not None:
            self._span.end()
            self._span = None
        self._active = False
        self._done = True

    def iteration_done(self, model, iteration, score):
        if self._done:
            return
        if not self._active and iteration >= self.start_iteration:
            try:
                self._start(model)
            except Exception as e:
                _log.warning("ProfilerListener: starting the trace failed "
                             "(%s); skipping this capture window", e)
                self._done = True
                return
            self._span = span("profiler_capture", log_dir=self.log_dir,
                              start_iteration=iteration,
                              n_iterations=self.end_iteration
                              - self.start_iteration).start()
            self._active = True
        elif self._active and iteration >= self.end_iteration:
            if getattr(model, "device", None) is not None and \
                    model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            self._stop()

    def on_epoch_end(self, model):
        # never leave a trace open across a short run
        if self._active:
            self._stop()
