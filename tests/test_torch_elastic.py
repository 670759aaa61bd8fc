"""Elastic fault-tolerant training in the port (``parallel/elastic.py``,
``parallel/faults.py``, ``util/async_checkpoint.py``): the reference's
``tests/test_elastic.py`` case by case on its tiny net (Dense 6->16 tanh,
Output 3 softmax, Adam(1e-2), 64 rows, B 8, 4 workers of the logical mesh),
and the same fault plans through the JAX package's ``ElasticTrainer`` (4 of
conftest's 8 CPU devices) and the port's from the same weights.

The reference's cases that read the telemetry registry
(``elastic.recoveries``, ``elastic.degraded_transitions``,
``elastic.checkpoint.dropped``) read the trainer's and the writer's own
results here (``recoveries``, ``degraded_transitions``, ``submit``'s False):
the registry is ROADMAP A8, part 2b. Its sync-freedom case counts the host
reads the step-loop thread makes (``Tensor.item``, ``tolist``, ``numpy``,
``cpu``, ``__bool__``, ``__float__``, ``__int__``) instead of the JAX host
sync detector. ``test_elastic_recovery_bench_smoke`` drives ``bench.py`` and
is not ported."""
import os
import signal
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize.updaters import Adam as JAdam
from deeplearning4j_tpu.parallel import ElasticTrainer as JElastic
from deeplearning4j_tpu.parallel import faults as jf
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam, Sgd
from deeplearning4j_tpu_torch.parallel import (
    CoordinationFlake, CorruptCheckpoint, ElasticTrainer, FaultInjector,
    FaultPlan, KillWorker, ParallelWrapper, PreemptAt, RecoveryFailedError,
    SlowCollective, make_mesh)
from deeplearning4j_tpu_torch.parallel.faults import (
    WorkerLostError, corrupt_newest_sharded, truncate_newest_sharded,
    truncate_newest_zip)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import held_specs
from deeplearning4j_tpu_torch.util import async_checkpoint as ac
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    is_valid, latest_sharded_step, read_manifest,
    restore_latest_sharded_checkpoint, save_sharded_checkpoint)
from deeplearning4j_tpu_torch.util.retry import RetryPolicy

R = np.random.default_rng(41)
_X = R.normal(size=(64, 6)).astype(np.float32)
_Y = np.eye(3, dtype=np.float32)[R.integers(0, 3, 64)]
W4 = [0, 1, 2, 3]


def _net(seed=7, updater=None):
    conf = (NeuralNetConfiguration(seed=seed, updater=updater or Adam(1e-2),
                                   dtype="float32")
            .list(tl.DenseLayer(n_in=6, n_out=16, activation="tanh"),
                  tl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _it(bs=8):
    return ListDataSetIterator(features=_X, labels=_Y, batch_size=bs)


def _flat(net):
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def _baseline(tmp_path, num_steps=20, **kw):
    a = _net()
    tr = ElasticTrainer(a, checkpoint_dir=str(tmp_path / "base"),
                        devices=W4, checkpoint_every_n_steps=4,
                        keep_last=4, **kw)
    tr.fit(_it(), num_steps=num_steps)
    return a, tr


# ------------------------------------------------------- async writer unit
def test_async_writer_writes_valid_checkpoints(tmp_path):
    tree = {"a": torch.arange(8.0)}
    w = ac.AsyncCheckpointWriter(str(tmp_path), keep_last=2)
    try:
        w.submit(5, tree, extra={"step_in_epoch": 3})
        assert w.flush(timeout=30.0)
    finally:
        w.close()
    assert w.last_completed_step == 5
    assert latest_sharded_step(str(tmp_path)) == 5
    assert read_manifest(str(tmp_path), 5)["extra"] == {"step_in_epoch": 3}
    step, got, extra = restore_latest_sharded_checkpoint(
        str(tmp_path), {"a": torch.zeros(8)})
    assert step == 5 and extra == {"step_in_epoch": 3}
    assert torch.equal(got["a"], torch.arange(8.0))


def test_async_writer_latest_wins_coalescing(tmp_path, monkeypatch):
    """A slow write coalesces queued submits: only the newest waiting
    snapshot is kept. The reference counts the drop in the registry; here
    the replaced submit returns False."""
    gate = threading.Event()
    written = []
    orig = ac.save_sharded_checkpoint

    def slow_save(directory, step, tree, **kw):
        gate.wait(10.0)
        written.append(step)
        return orig(directory, step, tree, **kw)

    monkeypatch.setattr(ac, "save_sharded_checkpoint", slow_save)
    tree = {"a": torch.ones(4)}
    w = ac.AsyncCheckpointWriter(str(tmp_path), keep_last=4)
    try:
        assert w.submit(1, tree)          # picked up by the (gated) writer
        time.sleep(0.05)
        assert w.submit(2, tree)          # waiting slot
        assert not w.submit(3, tree)      # replaces waiting 2: one drop
        gate.set()
        assert w.flush(timeout=30.0)
    finally:
        w.close()
    assert written == [1, 3]


def test_async_writer_survives_write_errors(tmp_path, monkeypatch):
    calls = {"n": 0}
    orig = ac.save_sharded_checkpoint

    def flaky(directory, step, tree, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk went away")
        return orig(directory, step, tree, **kw)

    monkeypatch.setattr(ac, "save_sharded_checkpoint", flaky)
    tree = {"a": torch.ones(4)}
    w = ac.AsyncCheckpointWriter(str(tmp_path))
    try:
        w.submit(1, tree)
        w.flush(timeout=30.0)
        assert isinstance(w.last_error, OSError)
        assert w.last_completed_step is None
        w.submit(2, tree)                  # the writer thread survived
        w.flush(timeout=30.0)
        assert w.last_completed_step == 2
    finally:
        w.close()


# ------------------------------------------------- sharded restore fallback
def _save_two(tmp_path):
    save_sharded_checkpoint(str(tmp_path), 1, {"a": torch.full((6,), 1.0)})
    save_sharded_checkpoint(str(tmp_path), 2, {"a": torch.full((6,), 2.0)})
    return {"a": torch.zeros(6)}


def test_restore_falls_back_past_truncated_newest(tmp_path):
    like = _save_two(tmp_path)
    assert truncate_newest_sharded(str(tmp_path)) == 2
    assert not is_valid(str(tmp_path), 2)
    assert is_valid(str(tmp_path), 1)
    assert latest_sharded_step(str(tmp_path)) == 1
    step, got, _ = restore_latest_sharded_checkpoint(str(tmp_path), like)
    assert step == 1
    assert torch.equal(got["a"], torch.full((6,), 1.0))


def test_restore_falls_back_past_corrupt_member(tmp_path):
    """Mid-file bit flips keep the zip directory (``is_zipfile`` passes);
    the CRC failure of the read falls back."""
    like = _save_two(tmp_path)
    assert corrupt_newest_sharded(str(tmp_path)) == 2
    step, got, _ = restore_latest_sharded_checkpoint(str(tmp_path), like)
    assert step == 1
    assert torch.equal(got["a"], torch.full((6,), 1.0))


def test_restore_with_nothing_valid_returns_like(tmp_path):
    like = {"a": torch.zeros(3)}
    step, got, extra = restore_latest_sharded_checkpoint(str(tmp_path), like)
    assert step is None and extra == {}
    assert got is like


def test_file_damage_helpers_on_empty_directories(tmp_path):
    assert truncate_newest_sharded(str(tmp_path)) is None
    assert corrupt_newest_sharded(str(tmp_path)) is None
    assert truncate_newest_zip(str(tmp_path)) is None


def test_truncate_newest_zip(tmp_path):
    for e in (1, 2):
        with open(tmp_path / f"checkpoint_epoch{e}.zip", "wb") as f:
            f.write(b"x" * 200)
    path = truncate_newest_zip(str(tmp_path), keep_bytes=10)
    assert path.endswith("checkpoint_epoch2.zip")
    assert os.path.getsize(path) == 10
    assert os.path.getsize(tmp_path / "checkpoint_epoch1.zip") == 200


# --------------------------------------------------------------- injector
def test_injector_order_within_a_step(tmp_path):
    """A kill listed first still comes last, after the disk damage and the
    preemption of its step (which run in the plan's order); flakes are
    armed by the step and consumed by ``on_coordinate``; a rejoining
    worker answers coordination, so ``surviving`` has it back."""
    class _T:
        checkpoint_dir = str(tmp_path)
        _writer = None
        preempted_at = None

        def _on_preempt(self):
            self.preempted_at = latest_sharded_step(str(tmp_path))

    _save_two(tmp_path)
    t = _T()
    inj = FaultInjector(FaultPlan(KillWorker(step=3, worker=2, rejoin=True),
                                  CorruptCheckpoint(step=3),
                                  PreemptAt(step=3),
                                  CoordinationFlake(step=3, failures=1)))
    inj.on_step(2, t)
    with pytest.raises(WorkerLostError, match="worker 2 lost at step 3"):
        inj.on_step(3, t)
    assert t.preempted_at == 1            # the damage came first
    assert inj.surviving(["a", "b", "c", "d"]) == ["a", "b", "d"]
    from deeplearning4j_tpu_torch.parallel.faults import CoordinationError
    with pytest.raises(CoordinationError):
        inj.on_coordinate()
    inj.on_coordinate()
    assert inj.coordination_attempts == 2
    assert inj.surviving(["a", "b", "c", "d"]) == ["a", "b", "c", "d"]


# ------------------------------------------------------------ elastic loop
def test_elastic_no_fault_matches_parallel_wrapper(tmp_path):
    """Supervision (the step callback and async checkpoints) adds nothing
    to the math: an unfaulted elastic run is bitwise a plain
    ParallelWrapper fit over the same steps."""
    a = _net()
    ParallelWrapper(a, mesh=make_mesh((4,), ("data",), "cpu"),
                    prefetch_buffer=0).fit(_it(), epochs=3)   # 24 steps
    b = _net()
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path), devices=W4,
                        checkpoint_every_n_steps=4)
    tr.fit(_it(), num_steps=24)
    assert tr.steps_done == 24 and tr.recoveries == 0
    assert torch.equal(_flat(a), _flat(b))


def test_kill_plus_truncated_checkpoint_recovers_bit_identical(tmp_path):
    """A worker kill at step 13 with the newest checkpoint truncated: the
    recovery skips the damaged save, restores the older one, re-forms the
    mesh (rejoin: the same shape) and ends bitwise the uninterrupted run
    (the reference's registry counter is ``recoveries`` here)."""
    a, _ = _baseline(tmp_path)
    b = _net()
    inj = FaultInjector(FaultPlan(
        CorruptCheckpoint(step=13, mode="truncate"),
        KillWorker(step=13, worker=1, rejoin=True)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "faulted"),
                        devices=W4, checkpoint_every_n_steps=4,
                        keep_last=4, fault_injector=inj)
    tr.fit(_it(), num_steps=20)
    assert tr.recoveries == 1
    assert tr.steps_done == 20
    assert tr.last_recovery_ms is not None and tr.last_recovery_ms > 0
    assert torch.equal(_flat(a), _flat(b))


def test_kill_without_rejoin_shrinks_mesh_and_converges(tmp_path):
    a, _ = _baseline(tmp_path)
    b = _net()
    inj = FaultInjector(FaultPlan(KillWorker(step=11, worker=2,
                                             rejoin=False)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "faulted"),
                        devices=W4, checkpoint_every_n_steps=4,
                        fault_injector=inj)
    tr.fit(_it(), num_steps=20)
    assert tr.recoveries == 1 and tr._devices == [0, 1, 3]
    assert tr._mesh.axis_sizes == (3,)
    assert tr.steps_done == 20
    np.testing.assert_allclose(_flat(a).numpy(), _flat(b).numpy(),
                               rtol=1e-4, atol=1e-5)


def test_recovery_through_fused_windows_bit_identical(tmp_path):
    """steps_per_dispatch=2: the loop runs windows; a kill and recovery
    resume mid-grid and still end bitwise the unfaulted per-step run."""
    a, _ = _baseline(tmp_path)
    b = _net()
    inj = FaultInjector(FaultPlan(KillWorker(step=14, worker=0,
                                             rejoin=True)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "w"), devices=W4,
                        checkpoint_every_n_steps=4, steps_per_dispatch=2,
                        fault_injector=inj)
    tr.fit(_it(), num_steps=20)
    assert tr.recoveries == 1
    assert torch.equal(_flat(a), _flat(b))


def test_recovery_with_a_prefetching_wrapper_starts_clean(tmp_path):
    """With ``prefetch_buffer=2`` a kill raises out of a wrapper whose
    feed runs a prefetch thread: the thread stops with the abandoned
    epoch, the fresh wrapper after the recovery starts clean, and the run
    still ends bitwise the unfaulted one (a list iterator restarts on
    every pass, so the race the default guards against cannot reorder
    it)."""
    a, _ = _baseline(tmp_path)
    b = _net()
    inj = FaultInjector(FaultPlan(KillWorker(step=13, worker=1,
                                             rejoin=True)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "p"), devices=W4,
                        checkpoint_every_n_steps=4, prefetch_buffer=2,
                        fault_injector=inj)

    def prefetchers():
        return {t for t in threading.enumerate()
                if t.name == "device-prefetch"}
    before = prefetchers()
    tr.fit(_it(), num_steps=20)
    assert tr.recoveries == 1
    assert torch.equal(_flat(a), _flat(b))
    deadline = time.time() + 5
    while time.time() < deadline and prefetchers() - before:
        time.sleep(0.05)
    assert not prefetchers() - before


def test_no_checkpoint_yet_restarts_from_scratch(tmp_path):
    a, _ = _baseline(tmp_path, num_steps=16)
    b = _net()
    inj = FaultInjector(FaultPlan(KillWorker(step=3, worker=1,
                                             rejoin=True)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "scratch"),
                        devices=W4, checkpoint_every_n_steps=100,
                        fault_injector=inj)
    tr.fit(_it(), num_steps=16)
    assert tr.recoveries == 1
    assert torch.equal(_flat(a), _flat(b))


def test_cross_process_resume_from_directory(tmp_path):
    """A fresh trainer on an existing checkpoint directory continues where
    the previous one stopped, bitwise the single run (the mid-epoch
    position from the manifest)."""
    a, _ = _baseline(tmp_path, num_steps=20)
    d = str(tmp_path / "resume")
    ElasticTrainer(_net(), checkpoint_dir=d, devices=W4,
                   checkpoint_every_n_steps=4).fit(_it(), num_steps=10)
    c = _net()
    tr = ElasticTrainer(c, checkpoint_dir=d, devices=W4,
                        checkpoint_every_n_steps=4)
    tr.fit(_it(), num_steps=20)
    assert tr.steps_done == 20
    assert torch.equal(_flat(a), _flat(c))


# ------------------------------------------------------------- coordination
def test_coordination_flakes_are_retried(tmp_path):
    a, _ = _baseline(tmp_path)
    b = _net()
    inj = FaultInjector(FaultPlan(
        KillWorker(step=13, worker=1, rejoin=True),
        CoordinationFlake(step=13, failures=2)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "flaky"),
                        devices=W4, checkpoint_every_n_steps=4,
                        fault_injector=inj,
                        retry_policy=RetryPolicy(max_attempts=4,
                                                 base_delay_s=0.001,
                                                 sleep=lambda s: None))
    tr.fit(_it(), num_steps=20)
    assert tr.recoveries == 1
    assert inj.coordination_attempts == 3      # 2 flakes + 1 success
    assert torch.equal(_flat(a), _flat(b))


def test_coordination_give_up_raises_recovery_failed(tmp_path):
    inj = FaultInjector(FaultPlan(
        KillWorker(step=6, worker=1, rejoin=True),
        CoordinationFlake(step=6, failures=10)))
    tr = ElasticTrainer(_net(), checkpoint_dir=str(tmp_path), devices=W4,
                        checkpoint_every_n_steps=4, fault_injector=inj,
                        retry_policy=RetryPolicy(max_attempts=3,
                                                 base_delay_s=0.001,
                                                 sleep=lambda s: None))
    with pytest.raises(RecoveryFailedError, match="gave up"):
        tr.fit(_it(), num_steps=20)


def test_max_recoveries_cap(tmp_path):
    plan = FaultPlan(*[KillWorker(step=s, worker=0, rejoin=True)
                       for s in (3, 6, 9)])
    tr = ElasticTrainer(_net(), checkpoint_dir=str(tmp_path), devices=W4,
                        checkpoint_every_n_steps=2, max_recoveries=2,
                        fault_injector=FaultInjector(plan))
    with pytest.raises(RecoveryFailedError, match="max_recoveries"):
        tr.fit(_it(), num_steps=20)


def test_no_surviving_workers_raises(tmp_path):
    plan = FaultPlan(KillWorker(step=2, worker=0))
    tr = ElasticTrainer(_net(), checkpoint_dir=str(tmp_path), devices=[0],
                        fault_injector=FaultInjector(plan))
    with pytest.raises(RecoveryFailedError, match="no surviving workers"):
        tr.fit(_it(), num_steps=8)


# ------------------------------------------------------------ degraded mode
def test_degraded_mode_enters_and_exits(tmp_path):
    """A slow-collective latency above the budget flips the loop into
    averaging windows (one collective a K steps) and back once the
    interconnect recovers (the registry's transition counter is the
    trainer's ``degraded_transitions`` here)."""
    b = _net()
    inj = FaultInjector(FaultPlan(
        SlowCollective(step=4, until_step=16, delay_ms=400.0)))
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path), devices=W4,
                        checkpoint_every_n_steps=100,
                        sync_latency_budget_ms=50.0, latency_window=2,
                        degraded_averaging_window=4,
                        degraded_exit_patience=2, fault_injector=inj)
    tr.fit(_it(), num_steps=32)
    assert tr.steps_done >= 32
    assert tr.degraded_transitions == 2
    assert [m for _, m in tr.mode_history] == ["averaging", "sync"]
    enter_step, exit_step = (s for s, _ in tr.mode_history)
    assert enter_step < 16 <= exit_step
    assert tr.mode == "sync"
    assert torch.isfinite(_flat(b)).all()


def test_refusals():
    with pytest.raises(ValueError, match="zero_stage does not compose"):
        ElasticTrainer(_net(), devices=W4, zero_stage=1,
                       sync_latency_budget_ms=10.0)
    with pytest.raises(ValueError, match="model-sharded mesh"):
        ElasticTrainer(_net(), devices=W4, mesh_shape=(2, 2),
                       sync_latency_budget_ms=10.0)
    with pytest.raises(ValueError, match="needs 4 devices"):
        ElasticTrainer(_net(), devices=[0, 1], mesh_shape=(2, 2))
    with pytest.raises(ValueError, match=r"\(d,\) or \(d, m\)"):
        ElasticTrainer(_net(), devices=W4, mesh_shape=(1, 2, 2))
    with pytest.raises(NotImplementedError, match="A8, part 2b"):
        ElasticTrainer(_net(), devices=W4, registry=object())


@pytest.mark.parametrize("survivors,shape", [(4, (2, 2)), (3, (3, 1)),
                                             (2, (2, 1)), (1, (1, 1))])
def test_mesh_policy(survivors, shape):
    tr = ElasticTrainer(_net(), devices=W4, mesh_shape=(2, 2))
    assert tr._mesh_for(W4[:survivors]).axis_sizes == shape
    one = ElasticTrainer(_net(), devices=W4)
    assert one._mesh_for(W4[:survivors]).axis_sizes == (survivors,)


def test_default_devices_are_the_default_mesh():
    tr = ElasticTrainer(_net())
    assert tr._devices == [0] and tr._mesh.axis_sizes == (1,)


# -------------------------------------------------------------- preemption
def test_preemption_flushes_final_checkpoint_and_resumes(tmp_path):
    a, _ = _baseline(tmp_path, num_steps=20)
    d = str(tmp_path / "preempt")
    b = _net()
    inj = FaultInjector(FaultPlan(PreemptAt(step=9)))
    tr = ElasticTrainer(b, checkpoint_dir=d, devices=W4,
                        checkpoint_every_n_steps=4, fault_injector=inj)
    tr.fit(_it(), num_steps=20)
    assert tr.preempted
    assert tr.steps_done == 9
    # the final save landed at exactly the preemption step
    assert latest_sharded_step(d) == 9
    assert read_manifest(d, 9)["extra"]["step_in_epoch"] == 1
    c = _net()
    tr2 = ElasticTrainer(c, checkpoint_dir=d, devices=W4,
                         checkpoint_every_n_steps=4)
    tr2.fit(_it(), num_steps=20)
    assert not tr2.preempted
    assert torch.equal(_flat(a), _flat(c))


def test_sigterm_guard_triggers_clean_preemption(tmp_path):
    class _SignalAt(FaultInjector):
        def __init__(self, at):
            super().__init__()
            self.at = at
            self.sent = False

        def on_step(self, step, trainer=None):
            if not self.sent and step >= self.at:
                self.sent = True
                signal.raise_signal(signal.SIGTERM)

    d = str(tmp_path)
    tr = ElasticTrainer(_net(), checkpoint_dir=d, devices=W4,
                        checkpoint_every_n_steps=4,
                        fault_injector=_SignalAt(at=6))
    with tr.preemption_guard() as guard:
        tr.fit(_it(), num_steps=20)
    assert guard.triggered and tr.preempted
    assert tr.steps_done == 6
    assert latest_sharded_step(d) == 6


# ------------------------------------------------- sync freedom (acceptance)
_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
          "__int__")


def _count_host_reads(monkeypatch):
    """Count the host reads of a tensor on this thread (the step loop):
    the writer thread's reads are its design and are not counted."""
    me = threading.get_ident()
    count = {"n": 0, "where": []}
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def wrap(self, *a, _orig=orig, _name=name, **kw):
            if threading.get_ident() == me:
                count["n"] += 1
                count["where"].append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrap)
    return count


def test_elastic_steady_state_adds_no_host_reads(tmp_path, monkeypatch):
    """A steady-state supervised loop with async checkpoints (the initial
    restore probe and periodic submits included) reads nothing back on
    the loop thread, as a plain wrapper fit over the same steps does
    not."""
    b = _net()
    d = str(tmp_path)
    tr = ElasticTrainer(b, checkpoint_dir=d, devices=W4,
                        checkpoint_every_n_steps=4, final_checkpoint=False)
    tr.fit(_it(), num_steps=8)                 # warm-up
    a = _net()
    pw = ParallelWrapper(a, mesh=make_mesh((4,), ("data",), "cpu"),
                         prefetch_buffer=0)
    pw.fit(_it(), epochs=1)
    count = _count_host_reads(monkeypatch)
    pw.fit(_it(), epochs=2)
    plain = count["n"]
    count["n"] = 0
    tr.fit(_it(), num_steps=24)                # restore -> loop -> submits
    monkeypatch.undo()
    assert tr.steps_done == 24
    assert plain == 0
    assert count["n"] == 0, count["where"]
    tr._writer = None
    assert latest_sharded_step(d) >= 20


def test_same_process_continuation_before_first_full_pass(tmp_path):
    a, _ = _baseline(tmp_path, num_steps=16)
    b = _net()
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path / "cont"),
                        devices=W4, checkpoint_every_n_steps=4)
    tr.fit(_it(), num_steps=5)           # stops mid-epoch, L unknown
    assert tr.steps_done == 5
    tr.fit(_it(), num_steps=16)          # continuation, same trainer
    assert tr.steps_done == 16
    assert torch.equal(_flat(a), _flat(b))


def test_non_resettable_exhausted_iterator_raises(tmp_path):
    b = _net()
    one_epoch = iter([d for d in _it()])     # no reset(): one pass only
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path), devices=W4,
                        checkpoint_every_n_steps=4)
    with pytest.raises(ValueError, match="resettable"):
        tr.fit(one_epoch, num_steps=20)      # the epoch has 8 batches
    assert b.iteration_count == 8            # the one pass did train


def test_averaging_path_remainder_batch_fallback():
    """The K-step averaging path on a batch that does not tile the mesh
    (what degraded mode meets on a shrunk mesh) runs the whole batch."""
    net = _net()
    pw = ParallelWrapper(net, mesh=make_mesh((3,), ("data",), "cpu"),
                         training_mode="averaging", averaging_frequency=4,
                         average_updaters=True, prefetch_buffer=0)
    pw.fit(_it(bs=8), epochs=1)           # 8 % 3 != 0 on every batch
    assert net.iteration_count == 8
    assert torch.isfinite(_flat(net)).all()


# ------------------------------------------------ ZeRO and the model axis
def test_zero_elastic_kill_truncate_bitwise_and_shrink(tmp_path):
    """ZeRO-2 under the trainer: a kill with rejoin over a truncated newest
    save ends bitwise the unfaulted ZeRO run; a kill without rejoin
    re-shards the [4, L] state onto 3 workers and converges."""
    a, _ = _baseline(tmp_path, zero_stage=2)
    manifest = read_manifest(str(tmp_path / "base"),
                             latest_sharded_step(str(tmp_path / "base")))
    assert manifest["sharding"]["format"] == "zero-flat"
    assert manifest["sharding"]["num_shards"] == 4
    b = _net()
    inj = FaultInjector(FaultPlan(CorruptCheckpoint(step=13),
                                  KillWorker(step=13, worker=1,
                                             rejoin=True)))
    ElasticTrainer(b, checkpoint_dir=str(tmp_path / "f"), devices=W4,
                   checkpoint_every_n_steps=4, keep_last=4, zero_stage=2,
                   fault_injector=inj).fit(_it(), num_steps=20)
    assert torch.equal(_flat(a), _flat(b))
    c = _net()
    tr = ElasticTrainer(c, checkpoint_dir=str(tmp_path / "s"), devices=W4,
                        checkpoint_every_n_steps=4, zero_stage=2,
                        fault_injector=FaultInjector(FaultPlan(
                            KillWorker(step=11, worker=3))))
    tr.fit(_it(), num_steps=20)
    assert tr.recoveries == 1 and tr._mesh.axis_sizes == (3,)
    assert c.opt_state["_zero_"][0]["m"].shape[0] == 3
    np.testing.assert_allclose(_flat(a).numpy(), _flat(c).numpy(),
                               rtol=1e-4, atol=1e-5)


def _lm_data(n=8, b=4, T=8, V=32, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, size=(n * b, T))
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, size=(n * b, T))]
    return ListDataSetIterator(features=np.eye(V, dtype=np.float32)[x],
                               labels=y, batch_size=b)


def test_model_axis_shrinks_to_3x1_and_reshards(tmp_path):
    """A (2, 2) trainer loses worker 3 for good: the mesh re-forms as
    (3, 1) by the reference's policy, the model-sharded save is gathered
    and restored onto the whole layout, and the run finishes within float
    tolerance of an uninterrupted (4,) run."""
    base = transformer_lm(32, d_model=16, n_heads=2, n_blocks=1,
                          max_length=8, updater=Sgd(1e-2),
                          device="cpu").init()
    ref = base.clone()
    ElasticTrainer(ref, checkpoint_dir=str(tmp_path / "r"), devices=W4,
                   checkpoint_every_n_steps=4).fit(_lm_data(), num_steps=12)
    net = base.clone()
    tr = ElasticTrainer(net, checkpoint_dir=str(tmp_path / "m"), devices=W4,
                        mesh_shape=(2, 2), checkpoint_every_n_steps=4,
                        fault_injector=FaultInjector(FaultPlan(
                            KillWorker(step=6, worker=3))))
    tr.fit(_lm_data(), num_steps=12)
    assert tr.recoveries == 1 and tr._mesh.axis_sizes == (3, 1)
    assert tr.steps_done == 12
    assert all(s == () for sd in held_specs(net).values()
               for s in sd.values())
    got, want = _flat(net).numpy(), _flat(ref).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------- parity with the JAX one
def test_the_package_exports_the_reference_s_names():
    import deeplearning4j_tpu.parallel as jpar
    import deeplearning4j_tpu_torch.parallel as tpar
    assert tpar.__all__ == jpar.__all__
    assert all(hasattr(tpar, name) for name in tpar.__all__)


def _jnet():
    conf = (JConf(seed=7, updater=JAdam(1e-2), dtype="float32")
            .list(jl.DenseLayer(n_in=6, n_out=16, activation="tanh"),
                  jl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())
    return JMLN(conf).init()


_PLANS = {
    "none": lambda m: m.FaultPlan(),
    "kill_truncate_rejoin": lambda m: m.FaultPlan(
        m.CorruptCheckpoint(step=13, mode="truncate"),
        m.KillWorker(step=13, worker=1, rejoin=True)),
    "kill_no_rejoin": lambda m: m.FaultPlan(
        m.KillWorker(step=11, worker=2, rejoin=False)),
    "slow_collective": lambda m: m.FaultPlan(
        m.SlowCollective(step=4, until_step=12, delay_ms=400.0)),
    "preempt_resume": lambda m: m.FaultPlan(m.PreemptAt(step=9)),
}


def _run_plan(make_trainer, make_inj, plan, it, d, num_steps):
    """A trainer under ``plan``; after a preemption a fresh trainer on the
    directory finishes the run. Returns (first trainer, last trainer)."""
    first = make_trainer(d, make_inj(plan))
    first.fit(it(), num_steps=num_steps)
    last = first
    if first.preempted:
        last = make_trainer(d, None)
        last.fit(it(), num_steps=num_steps)
    return first, last


@pytest.mark.parametrize("plan", sorted(_PLANS))
def test_parity_with_the_jax_elastic_trainer(plan, tmp_path):
    """The same weights under the same fault plan through the JAX
    ElasticTrainer and the port's: equal steps, recoveries, mode history,
    restored step and surviving workers; parameters within rel-to-max
    1e-5 (1e-4 on the shrunk mesh)."""
    import deeplearning4j_tpu_torch.parallel as tpar
    jnet, net = _jnet(), _net()
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    kw = dict(checkpoint_every_n_steps=4, keep_last=4)
    if plan == "slow_collective":
        kw.update(sync_latency_budget_ms=50.0, latency_window=2,
                  degraded_averaging_window=4, degraded_exit_patience=2)
    num_steps = 20
    restored = {}

    def track(tr, key):
        orig = tr._recover

        def rec(e):
            orig(e)
            restored[key] = tr.net.iteration_count
        tr._recover = rec
        return tr

    jfirst, jlast = _run_plan(
        lambda d, inj: track(JElastic(jnet, checkpoint_dir=d,
                                      devices=jax.devices()[:4],
                                      fault_injector=inj, **kw), "jax"),
        lambda p: jf.FaultInjector(p), _PLANS[plan](jf),
        lambda: JIter(features=_X, labels=_Y, batch_size=8),
        str(tmp_path / "jax"), num_steps)
    tfirst, tlast = _run_plan(
        lambda d, inj: track(ElasticTrainer(net, checkpoint_dir=d,
                                            devices=W4, fault_injector=inj,
                                            **kw), "port"),
        lambda p: FaultInjector(p), _PLANS[plan](tpar), _it,
        str(tmp_path / "port"), num_steps)
    for a, b in ((jfirst, tfirst), (jlast, tlast)):
        assert a.steps_done == b.steps_done
        assert a.recoveries == b.recoveries
        assert a.mode_history == b.mode_history
        assert a.preempted == b.preempted
        assert len(a._devices) == len(b._devices)
    assert restored.get("jax") == restored.get("port")
    assert tlast.steps_done == num_steps
    want = np.asarray(jnet.params_flat())
    got = net.params_flat().numpy()
    rel = 1e-4 if plan == "kill_no_rejoin" else 1e-5
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), plan


# ------------------------------------------------------------- chaos (slow)
@pytest.mark.slow
def test_chaos_soak_random_fault_plan(tmp_path):
    """Seeded random weather: kills (mixed rejoin), checkpoint damage,
    slow-collective windows. Four recoveries later the run completes every
    step with finite parameters."""
    rng = np.random.default_rng(1234)
    kills = sorted(rng.choice(np.arange(6, 120, 3), size=4, replace=False))
    faults = []
    for i, s in enumerate(kills):
        faults.append(KillWorker(step=int(s), worker=int(rng.integers(0, 4)),
                                 rejoin=bool(i % 2)))
        if i % 2:
            faults.append(CorruptCheckpoint(
                step=int(s), mode="truncate" if i % 4 else "flip"))
    faults.append(SlowCollective(step=40, until_step=70, delay_ms=300.0))
    b = _net()
    tr = ElasticTrainer(b, checkpoint_dir=str(tmp_path), devices=W4,
                        checkpoint_every_n_steps=5, keep_last=4,
                        sync_latency_budget_ms=60.0, latency_window=2,
                        degraded_averaging_window=4, max_recoveries=16,
                        fault_injector=FaultInjector(FaultPlan(*faults)))
    tr.fit(_it(), num_steps=130)
    assert tr.steps_done >= 130
    assert tr.recoveries == 4
    assert torch.isfinite(_flat(b)).all()
    assert torch.isfinite(b.output(_X[:8])).all()
