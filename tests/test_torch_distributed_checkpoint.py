"""Sharded checkpoints (``util/distributed_checkpoint.py``) and background
writes (``util/async_checkpoint.py``): the port's counterparts of the
reference's ``tests/test_distributed_checkpoint.py`` cases, a save the JAX
package wrote on its 8 virtual devices restored by the port (and the
port's read by the JAX package), the writer's latest-wins queue and
``flush``, and ``PreemptionGuard`` under a real SIGTERM."""
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.util import distributed_checkpoint as jdc
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.util import async_checkpoint as tac
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    DistributedCheckpointer, is_valid, latest_sharded_step,
    list_sharded_checkpoints, read_manifest,
    restore_latest_sharded_checkpoint, restore_sharded_checkpoint,
    save_sharded_checkpoint, tree_flatten, tree_unflatten)

R = np.random.default_rng(0)


def _tree():
    return {"w_data": torch.tensor(R.normal(size=(8, 6)).astype(np.float32)),
            "b_rep": torch.tensor(R.normal(size=(6,)).astype(np.float32)),
            "it": torch.tensor(7, dtype=torch.int32),
            "opt": {"_zero_": ({"m": torch.tensor(
                R.normal(size=(4, 5)).astype(np.float32))},)}}


def _like(tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [torch.zeros_like(t) for t in leaves])


def test_tree_order_is_jax_tree_leaves_order():
    """Leaves in ``jax.tree.leaves``' order: a dict's keys sorted, lists
    and tuples in order, None holding no leaf; ``tree_unflatten`` gives
    the structure back."""
    tree = {"b": (torch.zeros(1), None, [torch.ones(2)]), "a": torch.zeros(3),
            "c": {"y": torch.zeros(4), "x": torch.zeros(5)}}
    jtree = {"b": (jnp.zeros(1), None, [jnp.ones(2)]), "a": jnp.zeros(3),
             "c": {"y": jnp.zeros(4), "x": jnp.zeros(5)}}
    leaves, spec = tree_flatten(tree)
    assert [t.numel() for t in leaves] == \
        [int(a.size) for a in jax.tree.leaves(jtree)] == [3, 1, 2, 5, 4]
    ints = {10: torch.zeros(4), 2: torch.zeros(6), 1: torch.zeros(1)}
    assert [t.numel() for t in tree_flatten(ints)[0]] == [1, 6, 4]
    back = tree_unflatten(spec, leaves)
    assert set(back) == set(tree) and back["b"][1] is None
    assert isinstance(back["b"], tuple) and isinstance(back["b"][2], list)
    assert all(u is v for u, v in zip(tree_flatten(back)[0], leaves))


def test_round_trip_mixed_specs(tmp_path):
    """Replicated leaves, a scalar and the per-worker rows of a ZeRO state
    round-trip exactly; the rows are stored one block a worker."""
    tree = _tree()
    save_sharded_checkpoint(str(tmp_path), 3, tree)
    assert latest_sharded_step(str(tmp_path)) == 3
    got = restore_sharded_checkpoint(str(tmp_path), 3, _like(tree))
    for a, b in zip(tree_flatten(got)[0], tree_flatten(tree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(os.path.join(str(tmp_path), "ckpt_step3_p000.npz")) as z:
        blocks = sorted(k for k in z.files if not k.endswith("_idx"))
    # leaves: b_rep, it, opt m (4 rows), w_data
    assert blocks == ["l0_s0", "l1_s0", "l2_s0", "l2_s1", "l2_s2", "l2_s3",
                      "l3_s0"]


def test_shape_and_leafcount_mismatch_raise(tmp_path):
    tree = {"a": torch.ones(4, 4)}
    save_sharded_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="leaves"):
        restore_sharded_checkpoint(str(tmp_path), 1,
                                   {"a": torch.ones(4, 4),
                                    "b": torch.ones(4, 4)})
    with pytest.raises(ValueError, match="leaf 0"):
        restore_sharded_checkpoint(str(tmp_path), 1, {"a": torch.ones(2, 4)})


def _net(seed=5):
    conf = (NeuralNetConfiguration(seed=seed, updater=Adam(1e-2))
            .list(tl.DenseLayer(n_in=4, n_out=16, activation="tanh"),
                  tl.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent")).build())
    return MultiLayerNetwork(conf, device="cpu").init()


XS = R.normal(size=(48, 4)).astype(np.float32)
YS = np.eye(3, dtype=np.float32)[R.integers(0, 3, 48)]


def _state_tree(pw):
    net = pw.net
    return {"params": net.param_dicts(), "state": net.state_dicts(),
            "opt": net.opt_state}


def _load(net, pw, tree):
    """A restored tree copied into a fresh wrapper's network."""
    with torch.no_grad():
        for a, b in zip(tree_flatten(_state_tree(pw))[0],
                        tree_flatten(tree)[0]):
            a.copy_(b)


def test_kill_and_resume_parity(tmp_path):
    """A ZeRO wrapper saved every 3 steps of 6; a fresh wrapper restores
    the step-3 save and trains steps 4-6 bitwise the uninterrupted run."""
    mesh = make_mesh((4,), ("data",), "cpu")
    it = lambda: ListDataSetIterator(features=XS, labels=YS, batch_size=8)
    ck = DistributedCheckpointer(str(tmp_path), every_n_steps=3, keep_last=2)
    a = _net()
    pw = ParallelWrapper(a, mesh=mesh, zero_stage=2, step_callback=lambda
                         net, k: ck.maybe_save(net.iteration_count,
                                               _state_tree(pw)))
    pw.fit(it())
    assert [s for s, _ in list_sharded_checkpoints(str(tmp_path))] == [3, 6]
    for s, manifest in list_sharded_checkpoints(str(tmp_path)):
        if s > 3:
            os.unlink(manifest)
    b = _net(seed=9)
    pw2 = ParallelWrapper(b, mesh=mesh, zero_stage=2)
    b.opt_state = pw2._zero().init_opt_state()
    step, tree = ck.restore_latest(_state_tree(pw2))
    assert step == 3
    _load(b, pw2, tree)
    b.iteration_count = 3
    pw2.fit(it(), skip_first_batches=3)
    assert torch.equal(a.params_flat(), b.params_flat())
    for u, v in zip(tree_flatten(a.opt_state)[0],
                    tree_flatten(b.opt_state)[0]):
        assert torch.equal(u, v)


def test_pruning_keeps_last(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path), every_n_steps=1, keep_last=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"a": torch.ones(4)})
    assert [s for s, _ in list_sharded_checkpoints(str(tmp_path))] == [3, 4]
    assert not [n for n in os.listdir(str(tmp_path))
                if n.startswith("ckpt_step1_") or n.startswith("ckpt_step2_")]


def test_bfloat16_leaves_round_trip(tmp_path):
    tree = {"w": torch.tensor([[1.5, -2.25], [0.375, 8.0]],
                              dtype=torch.bfloat16),
            "b": torch.tensor([0.5, -1.0], dtype=torch.bfloat16)}
    save_sharded_checkpoint(str(tmp_path), 1, tree)
    got = restore_sharded_checkpoint(str(tmp_path), 1, _like(tree))
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k], tree[k])
    # the reference reads the port's bf16 save
    jlike = {k: jnp.zeros(tuple(v.shape), jnp.bfloat16)
             for k, v in tree.items()}
    jgot = jdc.restore_sharded_checkpoint(str(tmp_path), 1, jlike)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(jgot[k], np.float32),
                                      tree[k].float().numpy())


def test_incomplete_save_falls_back(tmp_path):
    tree = {"a": torch.arange(4.0)}
    save_sharded_checkpoint(str(tmp_path), 1, tree)
    save_sharded_checkpoint(str(tmp_path), 2, {"a": torch.arange(4.0) + 1})
    os.unlink(os.path.join(str(tmp_path), "ckpt_step2_p000.npz"))
    assert latest_sharded_step(str(tmp_path)) == 1
    step, got, _ = restore_latest_sharded_checkpoint(str(tmp_path),
                                                     _like(tree))
    assert step == 1 and torch.equal(got["a"], torch.arange(4.0))
    save_sharded_checkpoint(str(tmp_path), 3, {"a": torch.arange(4.0) + 2},
                            extra={"step_in_epoch": 2})
    with open(os.path.join(str(tmp_path), "ckpt_step3_p000.npz"),
              "r+b") as f:
        f.truncate(40)
    assert not is_valid(str(tmp_path), 3)
    step, got, extra = restore_latest_sharded_checkpoint(str(tmp_path),
                                                         _like(tree))
    assert step == 1 and extra == {}
    assert read_manifest(str(tmp_path), 3)["extra"] == {"step_in_epoch": 2}


def test_prune_never_deletes_only_complete_save(tmp_path):
    ck = DistributedCheckpointer(str(tmp_path), every_n_steps=1, keep_last=1)
    ck.save(1, {"a": torch.ones(2)})
    save_sharded_checkpoint(str(tmp_path), 2, {"a": torch.ones(2)})
    os.unlink(os.path.join(str(tmp_path), "ckpt_step2_p000.npz"))
    ck._prune()
    assert latest_sharded_step(str(tmp_path)) == 1
    assert [s for s, _ in list_sharded_checkpoints(str(tmp_path))] == [1, 2]


def test_a_jax_written_save_restores_in_the_port(tmp_path):
    """The reference writes on its 8 virtual devices (a leaf sharded on
    the data axis, one on the model axis, replicated ones, a bf16 leaf and
    a scalar); the port assembles every leaf from the blocks, bitwise."""
    mesh = jmake_mesh((4, 2), ("data", "model"), devices=jax.devices())
    r = np.random.default_rng(3)
    host = {"w_model": r.normal(size=(8, 6)).astype(np.float32),
            "w_data": r.normal(size=(8, 6)).astype(np.float32),
            "w_both": r.normal(size=(8, 6)).astype(np.float32),
            "b_rep": r.normal(size=(6,)).astype(np.float32)}
    specs = {"w_model": P(None, "model"), "w_data": P("data"),
             "w_both": P("data", "model"), "b_rep": P()}
    jtree = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
             for k, v in host.items()}
    jtree["bf"] = jax.device_put(jnp.asarray([1.5, -2.25], jnp.bfloat16),
                                 NamedSharding(mesh, P()))
    jtree["it"] = jax.device_put(jnp.asarray(7, jnp.int32),
                                 NamedSharding(mesh, P()))
    jdc.save_sharded_checkpoint(str(tmp_path), 4, jtree,
                                extra={"step_in_epoch": 3})
    like = {k: torch.zeros(v.shape) for k, v in host.items()}
    like["bf"] = torch.zeros(2, dtype=torch.bfloat16)
    like["it"] = torch.zeros((), dtype=torch.int32)
    step, got, extra = restore_latest_sharded_checkpoint(str(tmp_path), like)
    assert step == 4 and extra == {"step_in_epoch": 3}
    for k, v in host.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert torch.equal(got["bf"], torch.tensor([1.5, -2.25],
                                               dtype=torch.bfloat16))
    assert int(got["it"]) == 7


# ------------------------------------------------------------ async
def test_async_writer_latest_wins_and_flush(tmp_path):
    """While the writer is busy, a second and third submit replace each
    other (latest wins: the third returns False); ``flush`` drains, and the
    newest complete save is the last one submitted."""
    w = tac.AsyncCheckpointWriter(str(tmp_path), keep_last=5)
    gate = threading.Event()
    real = tac.save_sharded_checkpoint
    entered = threading.Event()

    def slow(*a, **kw):
        entered.set()
        gate.wait(10)
        return real(*a, **kw)

    tac.save_sharded_checkpoint = slow
    try:
        t = {"a": torch.zeros(3)}
        assert w.submit(1, t) is True
        assert entered.wait(10)            # step 1 is being written
        t["a"].add_(1.0)                   # the snapshot is a copy
        assert w.submit(2, t) is True
        assert w.submit(3, {"a": torch.full((3,), 3.0)}) is False
        assert w.pending
        gate.set()
        assert w.flush(timeout=10)
    finally:
        tac.save_sharded_checkpoint = real
    assert [s for s, _ in list_sharded_checkpoints(str(tmp_path))] == [1, 3]
    assert w.last_completed_step == 3 and w.last_error is None
    got = restore_sharded_checkpoint(str(tmp_path), 1, {"a": torch.ones(3)})
    assert torch.equal(got["a"], torch.zeros(3))
    w.save_sync(3, {"a": torch.ones(3)})    # already written: skipped
    w.save_sync(4, {"a": torch.ones(3)})
    assert latest_sharded_step(str(tmp_path)) == 4
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(5, {"a": torch.ones(3)})


def test_preemption_guard_sigterm_leads_to_a_sync_save(tmp_path):
    """A real SIGTERM to this process sets the guard's flag (and calls
    ``on_preempt``); the loop then writes its final save with
    ``save_sync``. The previous handler is back afterwards."""
    before = signal.getsignal(signal.SIGTERM)
    w = tac.AsyncCheckpointWriter(str(tmp_path))
    called = []
    try:
        with tac.PreemptionGuard(on_preempt=lambda: called.append(1)) as g:
            step = 0
            while not g.triggered and step < 100:
                step += 1
                w.submit(step, {"a": torch.full((2,), float(step))})
                if step == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
            w.save_sync(step, {"a": torch.full((2,), float(step))})
        assert g.triggered and called == [1] and step == 3
        assert latest_sharded_step(str(tmp_path)) == 3
    finally:
        w.close()
    assert signal.getsignal(signal.SIGTERM) == before
