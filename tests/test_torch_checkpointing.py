"""The write side of checkpointing (``util/checkpointing.py``):
``CheckpointListener``, ``fit_with_checkpointing`` and ``ProfilerListener``,
the port's counterparts of the reference's ``tests/test_checkpointing.py``
cases, plus the resumes the reference does not pin.

A resumed fit is held bitwise to the uninterrupted one: parameters,
updater state, iteration count and, for a network with
BatchNormalization, the layer state (``state.bin``), which the port
restores and the reference does not (its fault, pinned below by
``test_the_reference_resume_drops_batchnorm_statistics``)."""
import _torch_threads  # noqa: F401
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.util import checkpointing as jck
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    flat_opt_state_order)
from deeplearning4j_tpu_torch.util.checkpointing import (
    CheckpointListener, ProfilerListener, fit_with_checkpointing,
    is_valid_checkpoint, latest_checkpoint, list_checkpoints,
    read_checkpoint_manifest)
from deeplearning4j_tpu_torch.util.serialization import (restore_model,
                                                         write_model)

R = np.random.default_rng(29)
X = R.normal(size=(128, 5)).astype(np.float32)
Y = np.eye(2, dtype=np.float32)[(X.sum(-1) > 0).astype(int)]


def _layers(L, bn=False):
    if bn:
        return [L.DenseLayer(n_in=5, n_out=12, activation="identity"),
                L.BatchNormalization(activation="tanh"),
                L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]
    return [L.DenseLayer(n_in=5, n_out=12, activation="tanh"),
            L.OutputLayer(n_out=2, activation="softmax", loss="mcxent")]


def _net(seed=3, bn=False):
    conf = NeuralNetConfiguration(seed=seed, updater=Adam(5e-3),
                                  dtype="float32").list(
        *_layers(tl, bn)).build()
    return MultiLayerNetwork(conf, device="cpu").init()


def _it(n=128, bs=32):
    return ListDataSetIterator(features=X[:n], labels=Y[:n], batch_size=bs)


def _opt(net):
    return [t for *_, t in flat_opt_state_order(net)]


def _state(net):
    return [t for sd in net.state_dicts().values() for t in sd.values()]


def _assert_same_run(a, b):
    assert a.iteration_count == b.iteration_count
    assert torch.equal(a.params_flat(), b.params_flat())
    for u, v in zip(_opt(a) + _state(a), _opt(b) + _state(b)):
        assert torch.equal(u, v)


def test_checkpoint_listener_writes_and_prunes(tmp_path):
    net = _net()
    lis = CheckpointListener(str(tmp_path), every_n_epochs=1, keep_last=2)
    net.set_listeners(lis)
    net.fit(iterator=_it(), epochs=5)
    assert [e for _, e in list_checkpoints(str(tmp_path))] == [4, 5]
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_epoch5.zip")
    assert len(lis.write_s) == 5
    m = read_checkpoint_manifest(latest_checkpoint(str(tmp_path)))
    assert (m["epochs_done"], m["step_within_epoch"],
            m["iterations_done"]) == (5, 0, 20)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_fit_with_checkpointing_resumes(tmp_path):
    d = str(tmp_path / "ck")
    fit_with_checkpointing(_net(), _it(), epochs=3, checkpoint_dir=d)
    assert latest_checkpoint(d).endswith("epoch3.zip")
    b = _net()
    _, ran = fit_with_checkpointing(b, _it(), epochs=6, checkpoint_dir=d)
    assert ran == 3 and b.iteration_count == 24
    assert latest_checkpoint(d).endswith("epoch6.zip")
    c = _net()
    _, ran2 = fit_with_checkpointing(c, _it(), epochs=6, checkpoint_dir=d)
    assert ran2 == 0
    saved = restore_model(latest_checkpoint(d), device="cpu")
    _assert_same_run(c, saved)
    # and the whole resumed run equals an uninterrupted 6-epoch fit
    a = _net()
    a.fit(iterator=_it(), epochs=6, async_prefetch=False)
    _assert_same_run(a, b)


def test_latest_checkpoint_skips_truncated_newest(tmp_path):
    net = _net()
    net.set_listeners(CheckpointListener(str(tmp_path), keep_last=5))
    net.fit(iterator=_it(), epochs=3)
    newest = os.path.join(str(tmp_path), "checkpoint_epoch3.zip")
    with open(newest, "r+b") as f:
        f.truncate(40)
    assert not is_valid_checkpoint(newest)
    assert latest_checkpoint(str(tmp_path)).endswith("epoch2.zip")
    assert latest_checkpoint(str(tmp_path), validate=False).endswith(
        "epoch3.zip")


def test_fit_with_checkpointing_falls_back_on_corrupt_newest(tmp_path):
    d = str(tmp_path / "ck")
    fit_with_checkpointing(_net(), _it(), epochs=3, checkpoint_dir=d,
                           keep_last=5)
    with open(os.path.join(d, "checkpoint_epoch3.zip"), "r+b") as f:
        f.truncate(40)
    b = _net()
    _, ran = fit_with_checkpointing(b, _it(), epochs=6, checkpoint_dir=d,
                                    keep_last=5)
    assert ran == 4
    assert latest_checkpoint(d).endswith("epoch6.zip")
    a = _net()
    a.fit(iterator=_it(), epochs=6, async_prefetch=False)
    _assert_same_run(a, b)


class _RaiseAt(TrainingListener):
    """A crash at a global iteration."""

    class Boom(RuntimeError):
        pass

    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            raise self.Boom(f"crash at iteration {iteration}")


@pytest.mark.parametrize("bn", [False, True], ids=["dense", "batchnorm"])
def test_mid_epoch_resume_does_not_replay_epoch(tmp_path, bn):
    """``every_n_iterations`` saves: a crash mid-epoch resumes at the exact
    step, bitwise the uninterrupted run (parameters, updater state,
    iteration count and the BatchNormalization's running statistics)."""
    d = str(tmp_path / "ck")
    a = _net(bn=bn)
    a.fit(iterator=_it(), epochs=3, async_prefetch=False)
    b = _net(bn=bn)
    b.set_listeners(_RaiseAt(6))
    with pytest.raises(_RaiseAt.Boom):
        fit_with_checkpointing(b, _it(), epochs=3, checkpoint_dir=d,
                               every_n_iterations=2, keep_last=10)
    newest = latest_checkpoint(d)
    assert newest.endswith("epoch1_step2.zip")
    m = read_checkpoint_manifest(newest)
    assert (m["epochs_done"], m["step_within_epoch"],
            m["iterations_done"]) == (1, 2, 6)
    c = _net(bn=bn)
    _, ran = fit_with_checkpointing(c, _it(), epochs=3, checkpoint_dir=d,
                                    every_n_iterations=2, keep_last=10)
    assert ran == 2 and c.iteration_count == 12
    _assert_same_run(a, c)
    if bn:
        assert any(not torch.equal(t, torch.zeros_like(t))
                   and not torch.equal(t, torch.ones_like(t))
                   for t in _state(c))


def test_windowed_resume_with_epoch_boundary_saves(tmp_path):
    """``steps_per_dispatch=4`` with epoch-boundary saves across a 2-epoch
    fit, stopped after the first epoch's save and resumed: bitwise the
    uninterrupted windowed fit."""
    d = str(tmp_path / "ck")
    a = _net(bn=True)
    a.fit(iterator=_it(), epochs=2, steps_per_dispatch=4)
    b = _net(bn=True)
    b.set_listeners(_RaiseAt(5))
    with pytest.raises(_RaiseAt.Boom):
        fit_with_checkpointing(b, _it(), epochs=2, checkpoint_dir=d,
                               steps_per_dispatch=4)
    assert latest_checkpoint(d).endswith("epoch1.zip")
    c = _net(bn=True)
    _, ran = fit_with_checkpointing(c, _it(), epochs=2, checkpoint_dir=d,
                                    steps_per_dispatch=4)
    assert ran == 1
    _assert_same_run(a, c)


def test_windowed_mid_epoch_resume(tmp_path):
    """``steps_per_dispatch=4`` with saves every 4 steps: each save falls
    on a window's end, and a resume from the mid-epoch save is bitwise
    the uninterrupted windowed fit."""
    d = str(tmp_path / "ck")
    a = _net(bn=True)
    a.fit(iterator=_it(bs=16), epochs=2, steps_per_dispatch=4)
    b = _net(bn=True)
    b.set_listeners(_RaiseAt(13))
    with pytest.raises(_RaiseAt.Boom):
        fit_with_checkpointing(b, _it(bs=16), epochs=2, checkpoint_dir=d,
                               every_n_iterations=4, keep_last=10,
                               steps_per_dispatch=4)
    assert latest_checkpoint(d).endswith("epoch1_step4.zip")
    c = _net(bn=True)
    _, ran = fit_with_checkpointing(c, _it(bs=16), epochs=2,
                                    checkpoint_dir=d, every_n_iterations=4,
                                    keep_last=10, steps_per_dispatch=4)
    assert ran == 1 and c.iteration_count == 16
    _assert_same_run(a, c)


@pytest.mark.parametrize("how", ["fit_with_checkpointing", "listener",
                                 "resumed_step"])
def test_a_save_inside_a_window_is_refused(tmp_path, how):
    """A mid-epoch save inside a ``steps_per_dispatch`` window would store
    the window's end under a step inside it: ``every_n_iterations=2``
    with windows of 4 is refused before training, the listener set by
    hand raises rather than write it, and a resume from a step that is
    not a window boundary is refused before the restore."""
    d = str(tmp_path / "ck")
    net = _net()
    start = net.params_flat().clone()
    if how == "fit_with_checkpointing":
        with pytest.raises(ValueError, match="not a multiple of "
                                             "steps_per_dispatch"):
            fit_with_checkpointing(net, _it(), epochs=1, checkpoint_dir=d,
                                   every_n_iterations=2,
                                   steps_per_dispatch=4)
        assert net.iteration_count == 0
    elif how == "listener":
        net.set_listeners(CheckpointListener(d, every_n_iterations=2))
        with pytest.raises(ValueError, match="inside a steps_per_dispatch "
                                             "window"):
            net.fit(iterator=_it(), epochs=1, steps_per_dispatch=4)
    else:
        b = _net()
        b.set_listeners(_RaiseAt(3))
        with pytest.raises(_RaiseAt.Boom):
            fit_with_checkpointing(b, _it(), epochs=1, checkpoint_dir=d,
                                   every_n_iterations=2)
        assert latest_checkpoint(d).endswith("epoch0_step2.zip")
        with pytest.raises(ValueError, match="not a window boundary"):
            fit_with_checkpointing(net, _it(), epochs=1, checkpoint_dir=d,
                                   every_n_iterations=4,
                                   steps_per_dispatch=4)
        assert torch.equal(net.params_flat(), start)
        return
    assert list_checkpoints(d) == []


def test_old_boundary_checkpoints_still_load(tmp_path):
    d = str(tmp_path)
    net = _net()
    net.iteration_count = 8              # 2 epochs x 4 batches
    write_model(net, os.path.join(d, "checkpoint_epoch2.zip"))
    b = _net()
    _, ran = fit_with_checkpointing(b, _it(), epochs=3, checkpoint_dir=d)
    assert ran == 1 and b.iteration_count == 12
    assert latest_checkpoint(d).endswith("epoch3.zip")


def test_prune_only_touches_checkpoints_older_than_last_completed(tmp_path):
    d = str(tmp_path)
    for name in ("checkpoint_epoch1.zip", "checkpoint_epoch2.zip",
                 "checkpoint_epoch3.zip", "checkpoint_epoch3_step2.zip"):
        with open(os.path.join(d, name), "wb") as f:
            f.write(b"x")
    lst = CheckpointListener(d, keep_last=1)
    lst._prune()
    assert len(list_checkpoints(d)) == 4
    lst._last_completed = (2, 0)
    lst._prune()
    names = sorted(os.path.basename(p) for p, _ in list_checkpoints(d))
    assert names == ["checkpoint_epoch2.zip", "checkpoint_epoch3.zip",
                     "checkpoint_epoch3_step2.zip"]


def test_mid_epoch_checkpoints_prune_with_boundaries(tmp_path):
    net = _net()
    net.set_listeners(CheckpointListener(str(tmp_path), keep_last=3,
                                         every_n_iterations=2))
    net.fit(iterator=_it(), epochs=2)
    names = sorted(os.path.basename(p) for p, _ in
                   list_checkpoints(str(tmp_path)))
    assert names == ["checkpoint_epoch1_step2.zip",
                     "checkpoint_epoch1_step4.zip",
                     "checkpoint_epoch2.zip"]


def test_checkpoints_are_the_references_zips(tmp_path):
    """The listener's zips carry the reference's manifest keys, and each
    package restores the other's checkpoint directory."""
    jnet = JMLN(JConf(seed=3, updater=jupd.Adam(5e-3)).list(
        *_layers(jl)).build()).init()
    jnet.set_listeners(jck.CheckpointListener(str(tmp_path / "j"),
                                              every_n_iterations=2))
    jnet.fit(iterator=JIter(features=X, labels=Y, batch_size=32), epochs=1)
    net = _net()
    net.set_listeners(CheckpointListener(str(tmp_path / "p"),
                                         every_n_iterations=2))
    net.fit(iterator=_it(), epochs=1)
    jnames = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == jnames
    for name in jnames:
        with zipfile.ZipFile(tmp_path / "j" / name) as zj, \
                zipfile.ZipFile(tmp_path / "p" / name) as zp:
            mj = json.loads(zj.read("manifest.json"))
            mp = json.loads(zp.read("manifest.json"))
            assert set(mj) == set(mp)
            assert {k: mj[k] for k in ("epochs_done", "step_within_epoch",
                                       "iterations_done")} == \
                {k: mp[k] for k in ("epochs_done", "step_within_epoch",
                                    "iterations_done")}
    b = _net()
    _, ran = fit_with_checkpointing(b, _it(), epochs=1,
                                    checkpoint_dir=str(tmp_path / "j"))
    assert ran == 0 and b.iteration_count == 4
    np.testing.assert_array_equal(b.params_flat().numpy(),
                                  np.asarray(jnet.params_flat()))


def test_the_reference_resume_drops_batchnorm_statistics(tmp_path):
    """The reference's ``fit_with_checkpointing`` copies parameters,
    updater state and the iteration count but not ``restored.state``
    (``util/checkpointing.py:225-234``): a BatchNormalization network
    resumes with the statistics of its fresh init, not the zip's. The
    port restores them."""
    d = str(tmp_path / "ck")
    ja = JMLN(JConf(seed=3, updater=jupd.Adam(5e-3)).list(
        *_layers(jl, bn=True)).build()).init()
    jck.fit_with_checkpointing(ja, JIter(features=X, labels=Y,
                                         batch_size=32),
                               epochs=1, checkpoint_dir=d)
    saved = np.asarray(ja.state[1]["mean"])
    jb = JMLN(JConf(seed=3, updater=jupd.Adam(5e-3)).list(
        *_layers(jl, bn=True)).build()).init()
    fresh = np.asarray(jb.state[1]["mean"])
    _, ran = jck.fit_with_checkpointing(
        jb, JIter(features=X, labels=Y, batch_size=32), epochs=1,
        checkpoint_dir=d)
    assert ran == 0
    assert not np.array_equal(saved, fresh)
    np.testing.assert_array_equal(np.asarray(jb.state[1]["mean"]), fresh)
    np.testing.assert_array_equal(np.asarray(jb.params_flat()),
                                  np.asarray(ja.params_flat()))
    # the port resumes from the same zip with the saved statistics
    pb = _net(bn=True)
    _, ran = fit_with_checkpointing(pb, _it(), epochs=1, checkpoint_dir=d)
    assert ran == 0
    np.testing.assert_array_equal(pb.state_dicts()[1]["mean"].numpy(), saved)


def test_profiler_listener_writes_trace(tmp_path):
    net = _net()
    log_dir = str(tmp_path / "trace")
    lis = ProfilerListener(log_dir, start_iteration=1, n_iterations=2)
    net.set_listeners(lis)
    net.fit(iterator=_it(64, 16), epochs=2)
    assert lis.trace_path is not None and os.path.exists(lis.trace_path)
    with open(lis.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::mm")
               or str(e.get("name", "")).startswith("aten::addmm")
               for e in events)


def test_profiler_listener_skips_when_a_profiler_is_active(tmp_path, caplog):
    net = _net()
    lis = ProfilerListener(str(tmp_path / "t"), start_iteration=0,
                           n_iterations=2)
    net.set_listeners(lis)
    with torch.profiler.profile():
        net.fit(iterator=_it(64, 16))
    assert lis.trace_path is None and lis._done
    assert "skipping this capture window" in caplog.text
    assert net.iteration_count == 4
