"""Elastic fault-tolerant training: the supervised step loop.

Counterpart of ``deeplearning4j_tpu/parallel/elastic.py``
(``RecoveryFailedError`` and the control signals ``:71-94``,
``ElasticTrainer`` ``:97-665``): the reference's constructor, refusals and
results. :class:`ElasticTrainer` wraps ``ParallelWrapper.fit`` in a
supervised step loop that:

  - **checkpoints asynchronously** (``util/async_checkpoint.py``): the
    loop thread's ``submit`` copies the state on the device and returns;
    the writer thread copies it to the host and writes the sharded format
    (the manifest last). Nothing in the supervision reads the device.
  - **recovers from worker loss**: the mesh re-forms over the surviving
    workers (retry and backoff, ``util/retry.py``, on coordination flakes)
    and the run resumes from the newest checkpoint that restores, walking
    past truncated or corrupt saves. The same mesh resumes bitwise; a
    smaller one within float tolerance.
  - **degrades instead of stalling** (SparkNet, arXiv 1511.06051): when
    the per-step sync latency estimate exceeds ``sync_latency_budget_ms``
    the loop switches to K-step parameter averaging
    (``training_mode="averaging"``, ``average_updaters``) and back once the
    interconnect recovers.
  - **exits preemption cleanly**: SIGTERM (``preemption_guard``) or an
    injected ``PreemptAt`` sets a flag the loop reads at step boundaries;
    the final checkpoint is written synchronously and ``fit`` returns with
    ``preempted`` True.

**Workers, not devices.** The reference's ``devices`` is a list of chips.
Here it is a list of worker ids of the logical mesh (``parallel/mesh.py``:
n workers in one process on the network's device); ``None`` means every
worker of the default mesh, as the reference's means ``jax.devices()``.
A fault injector's ``surviving`` drops the killed ones by index and
``_mesh_for`` applies the reference's shape policy to the rest.

**The supervision seam** is ``ParallelWrapper(step_callback=...)``:
``_on_item`` raises one of four signals out of ``pw.fit`` (``_StopRun``,
``_Preempted``, ``_ModeSwitch``, ``WorkerLostError``). The wrapper calls
it after an item's steps are counted, so no window is mid-replay, and the
trainer's default ``prefetch_buffer=0`` runs no prefetch thread (a
prefetcher's thread stops on the generator's close). A wrapper is kept per
(mode, worker set) and reused after a signal: its captured windows read
the network's tensors, which stay the same objects.

**Recovery re-homes the network.** The restore target is the live network
laid out for the new mesh (``tensor_parallel.place_net`` at the new model
axis, the values unchanged; a ZeRO state as the new mesh's engine's
``init_opt_state``), restored through ``make_any_resharder`` and copied
into the network's own tensors (a ZeRO state of another worker count is
installed as restored). Every wrapper is dropped after a recovery
(programs are per mesh), so the next captures its windows again.

The reference's ``elastic.*`` counters, gauges and histogram, its
``elastic.fit`` / ``elastic.recover`` spans, the ``elastic.mode_switch``
event, the trace context and the flight-recorder dumps are telemetry
(ROADMAP A8, part 2b): the results carry the evidence (``recoveries``,
``degraded_transitions``, ``mode_history``, ``preempted``, ``steps_done``,
``last_recovery_ms``) and ``registry=`` other than None raises
``NotImplementedError``.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import List, Optional

import torch

from ..util.async_checkpoint import AsyncCheckpointWriter, PreemptionGuard
from ..util.distributed_checkpoint import (latest_sharded_step,
                                           restore_latest_sharded_checkpoint,
                                           tree_flatten)
from ..util.retry import RetryError, RetryPolicy
from .data_parallel import ParallelWrapper
from .faults import CoordinationError, FaultInjector, WorkerLostError
from .mesh import make_mesh
from .overlap import DEFAULT_BUCKET_BYTES
from .resharding import make_any_resharder
from .tensor_parallel import model_axis_size, place_net, tree_specs
from .zero import ZeroUpdateEngine

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["ElasticTrainer", "RecoveryFailedError"]


class RecoveryFailedError(RuntimeError):
    """Recovery exhausted its retry budget, ``max_recoveries`` or the
    workers."""


# control signals raised from the step callback (the one point where the
# parameters, the iteration count and the listeners agree)
class _StopRun(Exception):
    pass


class _Preempted(Exception):
    pass


class _ModeSwitch(Exception):
    def __init__(self, to: str):
        super().__init__(f"switch to {to}")
        self.to = to


def _default_retry_policy() -> RetryPolicy:
    return RetryPolicy(max_attempts=4, base_delay_s=0.05, max_delay_s=0.5,
                       retryable=lambda e: isinstance(
                           e, (CoordinationError, OSError)))


class ElasticTrainer:
    """Supervised elastic step loop over :class:`ParallelWrapper`.

        trainer = ElasticTrainer(net, checkpoint_dir="/ckpt",
                                 devices=[0, 1, 2, 3],
                                 checkpoint_every_n_steps=50)
        with trainer.preemption_guard():
            trainer.fit(iterator, num_steps=10_000)

    The iterator is an epoch stream that is ``reset()`` and run again
    until ``num_steps`` supervised steps are done; after a recovery the
    loop resumes at the restored step, skipping the trained prefix of the
    epoch (``skip_first_batches``; the position is in the checkpoint's
    manifest). ``prefetch_buffer`` defaults to 0: a recovery abandons the
    epoch mid-stream, and a prefetcher racing the iterator's ``reset()``
    would make the resumed stream nondeterministic.

    Results after ``fit``: ``steps_done``, ``recoveries``,
    ``degraded_transitions``, ``mode_history``, ``preempted``,
    ``last_recovery_ms``.
    """

    def __init__(self, net, *, checkpoint_dir: Optional[str] = None,
                 devices: Optional[List] = None,
                 mesh_shape: Optional[tuple] = None,
                 checkpoint_every_n_steps: int = 50, keep_last: int = 3,
                 steps_per_dispatch: int = 1, prefetch_buffer: int = 0,
                 max_recoveries: int = 8,
                 retry_policy: Optional[RetryPolicy] = None,
                 sync_latency_budget_ms: Optional[float] = None,
                 latency_window: int = 4,
                 degraded_averaging_window: int = 8,
                 degraded_exit_patience: int = 2,
                 final_checkpoint: bool = True,
                 fault_injector: Optional[FaultInjector] = None,
                 zero_stage: int = 0,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 registry=None):
        if registry is not None:
            raise NotImplementedError(
                "ElasticTrainer(registry=...): the elastic.* metrics, spans "
                "and flight-recorder dumps are telemetry, not ported yet "
                "(ROADMAP A8, part 2b); the trainer's results carry the "
                "evidence")
        self.net = net
        # the degraded mode averages whole per-worker state trajectories,
        # which a ZeRO-sharded updater state cannot hold
        if zero_stage and sync_latency_budget_ms is not None:
            raise ValueError(
                "zero_stage does not compose with the degraded "
                "averaging-window mode (sync_latency_budget_ms): "
                "averaging needs full per-worker updater state")
        self.zero_stage = zero_stage
        self.bucket_bytes = bucket_bytes
        self._engines = {}               # (shape, workers) -> engine
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every_n_steps = checkpoint_every_n_steps
        self.keep_last = keep_last
        self.steps_per_dispatch = steps_per_dispatch
        self.prefetch_buffer = prefetch_buffer
        self.max_recoveries = max_recoveries
        self.sync_latency_budget_ms = sync_latency_budget_ms
        self.latency_window = max(1, latency_window)
        self.degraded_averaging_window = max(2, degraded_averaging_window)
        self.degraded_exit_patience = max(1, degraded_exit_patience)
        self.final_checkpoint = final_checkpoint
        self._injector = fault_injector
        self._retry = retry_policy or _default_retry_policy()
        self._all_devices = list(
            devices if devices is not None
            else range(make_mesh(device=net.device).size))
        if mesh_shape is not None and len(mesh_shape) not in (1, 2):
            raise ValueError(f"mesh_shape must be (d,) or (d, m), "
                             f"got {mesh_shape}")
        self._mesh_shape = tuple(mesh_shape) if mesh_shape else None
        # a model-sharded layout cannot hold the full per-worker parameter
        # copies the averaging mode keeps
        if self._mesh_shape is not None and len(self._mesh_shape) == 2 \
                and self._mesh_shape[1] > 1 \
                and sync_latency_budget_ms is not None:
            raise ValueError(
                "a model-sharded mesh does not compose with the degraded "
                "averaging-window mode (sync_latency_budget_ms): "
                "averaging needs full per-worker param copies")
        if self._mesh_shape is not None:
            need = 1
            for s in self._mesh_shape:
                need *= int(s)
            if need > len(self._all_devices):
                raise ValueError(f"mesh_shape {self._mesh_shape} needs "
                                 f"{need} devices, have "
                                 f"{len(self._all_devices)}")
            self._devices = list(self._all_devices[:need])
        else:
            self._devices = list(self._all_devices)
        self._mesh = self._mesh_for(self._devices)
        self._wrappers = {}
        self._writer: Optional[AsyncCheckpointWriter] = None
        self._preempt_flag = False
        self._epoch_len: Optional[int] = None
        self._skip_next: Optional[int] = None
        self._pass_start = 0
        self._pass_skip = 0
        self._num_steps = 0
        self._next_ckpt_step = 0
        self._lat = deque(maxlen=self.latency_window)
        self._ok_items = 0
        self._t_item = 0.0
        # results
        self.mode = "sync"
        self.recoveries = 0
        self.degraded_transitions = 0
        self.mode_history: List[tuple] = []
        self.preempted = False
        self.steps_done = 0
        self.last_recovery_ms: Optional[float] = None

    # ------------------------------------------------------------ preemption
    def _on_preempt(self) -> None:
        """Signal-handler-safe: sets the flag only; the loop does the rest
        at the next step boundary."""
        self._preempt_flag = True

    def preemption_guard(self, signals=None) -> PreemptionGuard:
        """A context manager installing SIGTERM handlers that take the
        clean preemption path (final checkpoint, clean return)."""
        kw = {} if signals is None else {"signals": signals}
        return PreemptionGuard(on_preempt=self._on_preempt, **kw)

    # ----------------------------------------------------------------- mesh
    def _mesh_for(self, workers):
        """The reference's shape policy over a (possibly shrunk) worker
        set: 1-D stays ``(n,)``; ``(d, m)`` keeps its shape while the
        workers last, then ``(d, n // d)`` when that tiles, else
        ``(n, 1)`` (the model axis stays in the mesh either way)."""
        n = len(workers)
        shape, dev = self._mesh_shape, self.net.device
        if shape is None or len(shape) == 1:
            return make_mesh((n,), ("data",), dev)
        d, m = int(shape[0]), int(shape[1])
        if n == d * m:
            return make_mesh((d, m), ("data", "model"), dev)
        if n % d == 0 and n // d <= m:
            return make_mesh((d, n // d), ("data", "model"), dev)
        return make_mesh((n, 1), ("data", "model"), dev)

    # -------------------------------------------------------------- wrappers
    def _wrapper(self) -> ParallelWrapper:
        key = (self.mode, tuple(self._devices))
        pw = self._wrappers.get(key)
        if pw is None:
            if self.mode == "sync":
                pw = ParallelWrapper(
                    self.net, mesh=self._mesh,
                    steps_per_dispatch=self.steps_per_dispatch,
                    prefetch_buffer=self.prefetch_buffer,
                    zero_stage=self.zero_stage,
                    bucket_bytes=self.bucket_bytes,
                    step_callback=self._on_item)
                if self.zero_stage:
                    # one engine a mesh: the wrapper takes the trainer's,
                    # so its layout, sharding_meta and resharder agree
                    pw._zero_engine = self._engine_for(self._mesh,
                                                       self._devices)
            else:       # degraded: SparkNet-style infrequent-sync windows
                pw = ParallelWrapper(
                    self.net, mesh=self._mesh, training_mode="averaging",
                    averaging_frequency=self.degraded_averaging_window,
                    average_updaters=True,
                    prefetch_buffer=self.prefetch_buffer,
                    step_callback=self._on_item)
            self._wrappers[key] = pw
        return pw

    def _tree(self) -> dict:
        net = self.net
        return {"params": net.param_dicts(), "state": net.state_dicts(),
                "opt": net.opt_state}

    def _engine_for(self, mesh, workers) -> ZeroUpdateEngine:
        """The ZeRO layout for ``mesh`` over ``workers`` (one engine a
        worker set)."""
        key = (mesh.axis_sizes, tuple(workers))
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = ZeroUpdateEngine.from_net(
                self.net, mesh, stage=self.zero_stage,
                bucket_bytes=self.bucket_bytes)
        return eng

    def _sharding_meta(self) -> Optional[dict]:
        return (self._engine_for(self._mesh, self._devices).sharding_meta()
                if self.zero_stage else None)

    def _resharder(self, mesh, workers):
        """Restore hook (``parallel/resharding.py``): any saved layout
        (another worker count, model-sharded rows, a ZeRO flat state) onto
        ``mesh``'s."""
        return make_any_resharder(
            self._engine_for(mesh, workers) if self.zero_stage else None)

    @torch.no_grad()
    def _like_tree(self, mesh, workers) -> dict:
        """Restore target: the live network laid out for ``mesh``'s model
        axis (``place_net``, values unchanged) and, under ZeRO, the new
        mesh's engine's state. A ZeRO state is set aside while the
        parameters move (it is laid out over the data axis, not the
        model axis's rows)."""
        net = self.net
        m = model_axis_size(mesh)
        if self.zero_stage:
            opt, net.opt_state = net.opt_state, None
            try:
                place_net(net, m)
            finally:
                net.opt_state = opt
            opt_like = self._engine_for(mesh, workers).init_opt_state()
        else:
            place_net(net, m)
            opt_like = net.opt_state
        return {"params": net.param_dicts(), "state": net.state_dicts(),
                "opt": opt_like}

    @torch.no_grad()
    def _install(self, tree: dict) -> None:
        """Copy a restored tree into the network's own tensors (the
        captured windows of a kept wrapper read them); a state of another
        shape (ZeRO on another worker count) is installed as restored."""
        net = self.net
        for key in ("params", "state"):
            for live, new in zip(tree_flatten(self._tree()[key])[0],
                                 tree_flatten(tree[key])[0]):
                live.copy_(new)
        live, spec = tree_flatten(net.opt_state)
        new, new_spec = tree_flatten(tree["opt"])
        if spec == new_spec and all(a.shape == b.shape
                                    for a, b in zip(live, new)):
            for a, b in zip(live, new):
                a.copy_(b)
        else:
            net.opt_state = tree["opt"]

    # ------------------------------------------------------------- step hook
    def _step_in_epoch(self) -> int:
        return self._pass_skip + (self.net.iteration_count - self._pass_start)

    def _on_item(self, net, k: int) -> None:
        """The supervision seam: runs after every dispatched item (k
        steps), when the parameters, the iteration count and the listeners
        agree. Host bookkeeping only: nothing here reads the device."""
        it = net.iteration_count
        if self._injector is not None:
            self._injector.on_step(it, self)     # may raise WorkerLostError
        if self._writer is not None and self.checkpoint_every_n_steps \
                and it >= self._next_ckpt_step:
            self._submit_checkpoint(it)
            every = self.checkpoint_every_n_steps
            self._next_ckpt_step = (it // every + 1) * every
        if self.sync_latency_budget_ms is not None:
            self._update_latency(it, k)          # may raise _ModeSwitch
        if self._preempt_flag:
            raise _Preempted()
        if it >= self._num_steps:
            raise _StopRun()

    def _extra(self) -> dict:
        extra = {"step_in_epoch": self._step_in_epoch()}
        if self._epoch_len:
            extra["epoch_len"] = self._epoch_len
        return extra

    def _submit_checkpoint(self, it: int) -> None:
        tree = self._tree()
        self._writer.submit(it, tree, extra=self._extra(),
                            sharding=self._sharding_meta(),
                            specs=tree_specs(self.net, tree))

    # ------------------------------------------------------- degraded mode
    def _update_latency(self, it: int, k: int) -> None:
        """A per-step sync-latency estimate and the mode flips across the
        budget. With a fault injector the estimate is the synthetic
        per-collective delay over the sync period (1 step in sync mode, K
        in averaging mode: the SparkNet amortization, deterministic for
        tests); without one it is the measured wall time an item, which
        mixes compute and sync (coarse enough not to flap)."""
        now = time.perf_counter()
        dt_ms = (now - self._t_item) * 1e3
        self._t_item = now
        period = 1 if self.mode == "sync" else self.degraded_averaging_window
        if self._injector is not None:
            delay = self._injector.collective_delay_ms(it)
            est = delay / period
            exit_signal = delay          # the true per-collective cost
        else:
            est = dt_ms / max(1, k)
            # measured mode cannot separate the collective from compute,
            # so it exits on the whole item's time: if K steps and one
            # collective fit one step's budget, sync mode is healthy
            exit_signal = dt_ms
        if self.mode == "sync":
            self._lat.append(est)
            if len(self._lat) == self.latency_window and \
                    sum(self._lat) / len(self._lat) > self.sync_latency_budget_ms:
                raise _ModeSwitch("averaging")
        else:
            # exit when a full collective fits the budget again, with
            # patience against one-sample blips
            self._ok_items = self._ok_items + 1 \
                if exit_signal <= self.sync_latency_budget_ms else 0
            if self._ok_items >= self.degraded_exit_patience:
                raise _ModeSwitch("sync")

    def _switch_mode(self, to: str) -> None:
        self.degraded_transitions += 1
        self.mode_history.append((self.net.iteration_count, to))
        self.mode = to
        self._lat.clear()
        self._ok_items = 0
        log.warning("elastic: %s mode at step %d (sync latency budget "
                    "%s ms)", "entering degraded averaging-window" if
                    to != "sync" else "returning to per-step sync",
                    self.net.iteration_count, self.sync_latency_budget_ms)

    # --------------------------------------------------------------- recover
    def _recover(self, exc: BaseException) -> None:
        self.recoveries += 1
        if self.recoveries > self.max_recoveries:
            raise RecoveryFailedError(
                f"recovery #{self.recoveries} exceeds max_recoveries="
                f"{self.max_recoveries}") from exc
        t0 = time.perf_counter()
        if self._writer is not None:
            self._writer.flush()

        def attempt():
            if self._injector is not None:
                self._injector.on_coordinate()   # may raise (retried)
            workers = (self._injector.surviving(self._all_devices)
                       if self._injector is not None
                       else list(self._all_devices))
            if not workers:
                raise RecoveryFailedError("no surviving workers")
            mesh = self._mesh_for(workers)
            like = self._like_tree(mesh, workers)
            if self.checkpoint_dir is not None:
                step, tree, extra = restore_latest_sharded_checkpoint(
                    self.checkpoint_dir, like,
                    resharder=self._resharder(mesh, workers))
            else:
                step, tree, extra = None, like, {}
            return workers, mesh, step, tree, extra

        try:
            workers, mesh, step, tree, extra = self._retry.call(
                attempt,
                on_retry=lambda i, e: log.warning(
                    "elastic: coordination attempt %d failed (%s); "
                    "backing off", i + 1, e))
        except RecoveryFailedError:
            raise
        except RetryError as e:
            raise RecoveryFailedError(
                f"mesh re-form/restore gave up: {e}") from e

        if len(workers) != len(self._devices):
            log.warning("elastic: mesh re-formed with %d workers (was %d)",
                        len(workers), len(self._devices))
        self._devices = workers
        self._mesh = mesh
        self._wrappers = {}          # programs are per mesh
        keep = (mesh.axis_sizes, tuple(workers))
        self._engines = {k: v for k, v in self._engines.items() if k == keep}
        net = self.net
        if step is None:
            # nothing restorable: a deterministic restart from scratch
            log.warning("elastic: no restorable checkpoint in %r; "
                        "restarting from step 0", self.checkpoint_dir)
            net.init()
            net.iteration_count = 0
            self._skip_next = 0
        else:
            self._install(tree)
            net.iteration_count = step
            self._skip_next = int(extra.get("step_in_epoch", 0))
            if self._epoch_len is None and extra.get("epoch_len"):
                self._epoch_len = int(extra["epoch_len"])
        every = self.checkpoint_every_n_steps or 1
        self._next_ckpt_step = (net.iteration_count // every + 1) * every
        self._lat.clear()
        self._ok_items = 0
        self.last_recovery_ms = (time.perf_counter() - t0) * 1e3
        log.warning("elastic: recovered to step %s on a %d-worker mesh in "
                    "%.0f ms", net.iteration_count, len(workers),
                    self.last_recovery_ms)

    def _initial_restore(self) -> None:
        """A fresh trainer pointed at an existing checkpoint directory
        continues where the previous process stopped. A live trainer whose
        state is ahead of the newest save (a second ``fit`` continuing the
        run) is never rolled back: the manifest scan is checked first, so
        such a fit pays no shard reads."""
        newest = latest_sharded_step(self.checkpoint_dir)
        if newest is None or newest <= self.net.iteration_count:
            return
        step, tree, extra = restore_latest_sharded_checkpoint(
            self.checkpoint_dir, self._like_tree(self._mesh, self._devices),
            resharder=self._resharder(self._mesh, self._devices))
        # the restore may fall back to an older save than the scan saw
        # (a corrupt member shows only on read)
        if step is None or step <= self.net.iteration_count:
            return
        net = self.net
        self._install(tree)
        self._wrappers = {}
        net.iteration_count = step
        self._skip_next = int(extra.get("step_in_epoch", 0))
        if extra.get("epoch_len"):
            self._epoch_len = int(extra["epoch_len"])
        log.info("elastic: resuming from checkpoint step %d", step)

    # ------------------------------------------------------------------- fit
    def fit(self, iterator, *, num_steps: int):
        net = self.net
        if not net.initialized:
            net.init()
        self._num_steps = num_steps
        self._preempt_flag = False
        self.preempted = False
        self.steps_done = 0
        if self.checkpoint_dir is not None:
            self._writer = AsyncCheckpointWriter(self.checkpoint_dir,
                                                 keep_last=self.keep_last)
        try:
            if self.checkpoint_dir is not None:
                self._initial_restore()
            every = self.checkpoint_every_n_steps or 1
            self._next_ckpt_step = (net.iteration_count // every + 1) * every
            self._pass_start = net.iteration_count
            self._pass_skip = self._skip_next or 0
            while net.iteration_count < num_steps and not self._preempt_flag:
                skip = self._skip_next
                if skip is None:
                    L = self._epoch_len
                    skip = (net.iteration_count % L) if L else 0
                self._skip_next = None
                self._pass_start = net.iteration_count
                self._pass_skip = skip
                self._t_item = time.perf_counter()
                if hasattr(iterator, "reset"):
                    iterator.reset()
                pw = self._wrapper()
                try:
                    pw.fit(iterator, epochs=1, skip_first_batches=skip)
                except (_StopRun, _Preempted):
                    # the mid-epoch position, so a continuation fit() on
                    # this trainer resumes here (it % epoch_len is not
                    # known before the first clean pass)
                    self._skip_next = self._step_in_epoch()
                    break
                except _ModeSwitch as ms:
                    consumed = self._step_in_epoch()
                    self._switch_mode(ms.to)
                    self._skip_next = consumed
                    continue
                except WorkerLostError as e:
                    self._recover(e)
                    continue
                # a clean pass: the epoch's length
                n_pass = self._step_in_epoch()
                if n_pass == 0:
                    # an exhausted iterator that cannot reset would spin
                    # here forever at zero progress
                    raise ValueError(
                        f"iterator yielded no batches at step "
                        f"{net.iteration_count} of {num_steps}: "
                        f"ElasticTrainer re-runs the iterator per "
                        f"pass and needs it resettable (reset()) or "
                        f"re-iterable")
                self._epoch_len = n_pass
                self._skip_next = 0
            if self._preempt_flag:
                self.preempted = True
        finally:
            writer, self._writer = self._writer, None
            if writer is not None:
                try:
                    it = net.iteration_count
                    if (self.final_checkpoint or self.preempted) and it > 0:
                        tree = self._tree()
                        writer.save_sync(it, tree, extra=self._extra(),
                                         sharding=self._sharding_meta(),
                                         specs=tree_specs(self.net, tree))
                finally:
                    writer.close()
        self.steps_done = net.iteration_count
        return net
