"""The ZeRO sharded update (``parallel/zero.py``) and its wrapper paths
against the port's own replicated update and against the JAX package's
``parallel/zero.py`` on its virtual CPU devices.

The port's pin is bitwise: ZeRO stages 1 and 2, at every bucket size, with
Sgd and Adam, end a fit with the plain sync wrapper's parameters and (after
``gather_opt_state``) its updater state, because every element of the
flat update sees the arithmetic the per-leaf update gives it (and the
mean over the workers adds the rows in worker order on every path).

Against the JAX package the pin is 1e-6 rel-to-max: the reference's own
bitwise pin of its ZeRO update against its replicated one fails on this
JAX version by one ulp in a few elements (XLA on the CPU rounds the sharded
and the whole-tree elementwise update differently), and the two packages'
forward and backward passes differ in the last bits anyway. The elastic
trainer's cases are ROADMAP A7b-3 and the telemetry's A8, part 2."""
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import updaters as jupd
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import ZeroUpdateEngine as JZero
from deeplearning4j_tpu.parallel import mesh as jmesh
from deeplearning4j_tpu.util import distributed_checkpoint as jdc
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import updaters as tupd
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    flat_opt_state_order, flat_param_order)
from deeplearning4j_tpu_torch.parallel.zero import (ZeroUpdateEngine,
                                                    is_zero_state,
                                                    make_zero_resharder)
from deeplearning4j_tpu_torch.util import distributed_checkpoint as tdc
from deeplearning4j_tpu_torch.util.serialization import write_model

R = np.random.default_rng(47)
X = R.normal(size=(128, 6)).astype(np.float32)
YI = (X.sum(-1) > 0).astype(int) + (X[:, 0] > 1).astype(int)
Y = np.eye(3, dtype=np.float32)[YI]


def _layers(L, bias_lr=None, frozen=False, act_layer=False):
    kw = {"bias_learning_rate": bias_lr} if bias_lr else {}
    if act_layer:
        return [L.DenseLayer(n_in=6, n_out=16, activation="identity"),
                L.ActivationLayer(activation="tanh"),
                L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]
    return [L.DenseLayer(n_in=6, n_out=24, activation="tanh", frozen=frozen),
            L.DenseLayer(n_in=24, n_out=16, activation="tanh", **kw),
            L.OutputLayer(n_out=3, activation="softmax", loss="mcxent")]


def _net(updater="adam", **kw):
    upd = {"adam": tupd.Adam(5e-3), "sgd": tupd.Sgd(0.1)}[updater]
    conf = NeuralNetConfiguration(seed=7, updater=upd,
                                  dtype="float32").list(
        *_layers(tl, **kw)).build()
    return MultiLayerNetwork(conf, device="cpu").init()


def _jnet(updater="adam", **kw):
    upd = {"adam": jupd.Adam(5e-3), "sgd": jupd.Sgd(0.1)}[updater]
    conf = JConf(seed=7, updater=upd, dtype="float32").list(
        *_layers(jl, **kw)).build()
    return JMLN(conf).init()


def _mesh(n=4):
    return make_mesh((n,), ("data",), "cpu")


def _it(n=128, bs=32):
    return ListDataSetIterator(features=X[:n], labels=Y[:n], batch_size=bs)


def _fit(net, epochs=2, n=128, bs=32, **kw):
    pw = ParallelWrapper(net, mesh=_mesh(kw.pop("workers", 4)), **kw)
    pw.fit(_it(n, bs), epochs=epochs)
    return pw


def _opt(net):
    return [t for *_, t in flat_opt_state_order(net)]


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b)) and len(a) == len(b)


# ------------------------------------------------------------------ layout
def test_groups_partition_every_unfrozen_leaf_once():
    net = _net()
    eng = ZeroUpdateEngine.from_net(net, _mesh(), stage=2, bucket_bytes=256)
    seen = sorted(i for g in eng.groups for b in g.buckets
                  for i in b.indices)
    assert seen == list(range(len(flat_param_order(net))))
    for g in eng.groups:
        for b in g.buckets:
            assert b.lb == -(-b.nb // eng.n)        # ceil padding
        assert g.length == sum(b.lb for b in g.buckets)
    # the reference's layout of the same network, group for group
    jeng = JZero.from_net(_jnet(), jmesh.make_mesh((4,), ("data",),
                                                  jax.devices()[:4]),
                          stage=2, bucket_bytes=256)
    mine, theirs = eng.sharding_meta(), jeng.sharding_meta()
    assert mine == theirs


def test_layout_splits_heterogeneous_lr_into_groups():
    uniform = ZeroUpdateEngine.from_net(_net(), _mesh(), stage=1)
    assert len(uniform.groups) == 1
    split = ZeroUpdateEngine.from_net(_net(bias_lr=0.5), _mesh(), stage=1)
    assert len(split.groups) == 2
    mults = sorted(g.lr_mult for g in split.groups)
    assert mults[0] == 1.0 and mults[1] != 1.0


def test_engine_rejects_grad_norm_and_bad_stage():
    conf = (NeuralNetConfiguration(seed=1, updater=tupd.Sgd(0.1),
                                   gradient_normalization="clipl2perlayer")
            .list(tl.DenseLayer(n_in=4, n_out=4, activation="tanh"),
                  tl.OutputLayer(n_out=2, activation="softmax",
                                 loss="mcxent")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="normalization"):
        ZeroUpdateEngine.from_net(net, _mesh())
    with pytest.raises(ValueError, match="stage"):
        ZeroUpdateEngine.from_net(_net(), _mesh(), stage=3)


def test_wrapper_rejects_bad_combinations():
    from deeplearning4j_tpu_torch.parallel.accumulation import PsumAccumulator
    with pytest.raises(ValueError, match="zero_stage"):
        ParallelWrapper(_net(), mesh=_mesh(), zero_stage=1,
                        gradient_accumulator=PsumAccumulator())
    with pytest.raises(ValueError, match="averaging"):
        ParallelWrapper(_net(), mesh=_mesh(), zero_stage=1,
                        training_mode="averaging", averaging_frequency=4)
    with pytest.raises(ValueError, match="zero_stage"):
        ParallelWrapper(_net(), mesh=_mesh(), zero_stage=7)
    with pytest.raises(ValueError, match="overlap_sync"):
        ParallelWrapper(_net(), mesh=_mesh(), zero_stage=2,
                        overlap_sync=True)
    # averaging_frequency=1 IS the sync path: allowed
    ParallelWrapper(_net(), mesh=_mesh(), zero_stage=2,
                    training_mode="averaging", averaging_frequency=1)


def test_zero_handles_parameterless_layers():
    ref, net = _net(act_layer=True), _net(act_layer=True)
    _fit(ref)
    pw = _fit(net, zero_stage=2)
    assert torch.equal(ref.params_flat(), net.params_flat())
    pw.gather_opt_state()
    assert list(net.opt_state) == list(ref.opt_state)
    assert net.opt_state[1] == {}          # the activation layer's group
    assert _same(_opt(net), _opt(ref))


def test_zero_frozen_layer_state_round_trips(tmp_path):
    from deeplearning4j_tpu_torch.util.serialization import (
        restore_multilayer_network)
    ref, net = _net(frozen=True), _net(frozen=True)
    _fit(ref)
    pw = _fit(net, zero_stage=2)
    assert torch.equal(ref.params_flat(), net.params_flat())
    pw.gather_opt_state()
    assert _same(_opt(net), _opt(ref))
    path = str(tmp_path / "m.zip")
    write_model(net, path)
    back = restore_multilayer_network(path, device="cpu")
    assert torch.equal(back.params_flat(), net.params_flat())
    poisoned = _net(frozen=True)
    for t in _opt(poisoned):
        t.add_(1.0)
    eng = ZeroUpdateEngine.from_net(poisoned, _mesh(), stage=2)
    with pytest.raises(ValueError, match="frozen"):
        eng.shard_opt_state(poisoned.opt_state)


def test_state_shard_roundtrip_and_bytes():
    net = _net()
    _fit(net, epochs=1)                      # a nonzero state
    eng = ZeroUpdateEngine.from_net(net, _mesh(8), stage=2, bucket_bytes=512)
    sharded = eng.shard_opt_state(net.opt_state)
    assert is_zero_state(sharded)
    rep = eng.unshard_opt_state(sharded)
    back = eng.shard_opt_state(rep)
    for a, b in zip(tdc.tree_flatten(sharded)[0], tdc.tree_flatten(back)[0]):
        assert torch.equal(a, b)
    flat = [rep[g][p][s] for g, p, s, _ in flat_opt_state_order(net)]
    assert _same(flat, _opt(net))
    ratio = eng.replicated_state_bytes / eng.shard_state_bytes
    assert ratio >= 0.75 * eng.n, ratio
    eng2 = ZeroUpdateEngine.from_net(net, _mesh(4), stage=2,
                                     bucket_bytes=512)
    with pytest.raises(ValueError, match="re-shard"):
        eng2.check_state(sharded)


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("updater", ["sgd", "adam"])
@pytest.mark.parametrize("bucket_bytes", [256, 4 * 2 ** 20, 1 << 30])
def test_zero_stages_bitwise_the_replicated_update(updater, bucket_bytes):
    """Stages 1 and 2 at every bucket size end with the plain sync
    wrapper's parameters and updater state, bitwise."""
    ref = _net(updater)
    _fit(ref)
    for stage in (1, 2):
        net = _net(updater)
        pw = _fit(net, zero_stage=stage, bucket_bytes=bucket_bytes)
        assert is_zero_state(net.opt_state)
        assert torch.equal(ref.params_flat(), net.params_flat()), stage
        pw.gather_opt_state()
        assert _same(_opt(net), _opt(ref)), stage


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_matches_the_reference_zero(stage):
    """The port's ZeRO fit against the JAX package's on 4 devices, from the
    same weights: rel-to-max 1e-6 on the parameters and the gathered Adam
    state (see the module docstring for why not bitwise)."""
    jnet, net = _jnet(), _net()
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    jpw = JPW(jnet, mesh=jmesh.make_mesh((4,), ("data",), jax.devices()[:4]),
              zero_stage=stage)
    jpw.fit(JIter(features=X, labels=Y, batch_size=32), epochs=2)
    pw = _fit(net, zero_stage=stage)
    jflat = np.asarray(jnet.params_flat())
    got = net.params_flat().numpy()
    assert np.abs(got - jflat).max() <= 1e-6 * np.abs(jflat).max()
    jpw.gather_opt_state()
    pw.gather_opt_state()
    jst = [np.asarray(v) for v in jax.tree.leaves(jnet.opt_state)]
    for a, b in zip(_opt(net), jst):
        assert np.abs(a.numpy() - b).max() <= 1e-6 * max(np.abs(b).max(),
                                                          1e-30)


def test_zero_window_bit_identical_to_per_step():
    a, b = _net(), _net()
    _fit(a, zero_stage=2)
    pw = _fit(b, zero_stage=2, steps_per_dispatch=2)
    assert torch.equal(a.params_flat(), b.params_flat())
    assert pw.graph_stats()["captures"] == 0        # eager on the CPU


def test_zero_remainder_batch_dispatches_replicated_feed():
    """A batch of 36 does not tile 8 workers: it takes one whole-batch step,
    with the sharded update, bitwise the plain wrapper's and close to the
    single network's fit."""
    single = _net()
    single.fit(iterator=_it(100, 64), epochs=2, async_prefetch=False)
    ref, net = _net(), _net()
    _fit(ref, n=100, bs=64, workers=8)
    _fit(net, n=100, bs=64, workers=8, zero_stage=2)
    assert torch.equal(ref.params_flat(), net.params_flat())
    np.testing.assert_allclose(net.params_flat().numpy(),
                               single.params_flat().numpy(),
                               rtol=2e-5, atol=2e-6)


def test_zero_bias_lr_override_parity():
    ref, net = _net(bias_lr=0.5), _net(bias_lr=0.5)
    _fit(ref)
    pw = _fit(net, zero_stage=2)
    assert len(pw._zero().groups) == 2
    assert torch.equal(ref.params_flat(), net.params_flat())


def test_gather_opt_state_restores_replicated_format():
    net = _net()
    pw = _fit(net, epochs=1, zero_stage=2)
    assert is_zero_state(net.opt_state)
    pw.gather_opt_state()
    assert not is_zero_state(net.opt_state)
    fresh = net.updater.init(net.param_dicts())
    assert {g: {p: sorted(s) for p, s in d.items()}
            for g, d in net.opt_state.items()} == \
        {g: {p: sorted(s) for p, s in d.items()} for g, d in fresh.items()}
    # a fit after the gather re-shards and goes on
    pw.fit(_it(), epochs=1)
    assert is_zero_state(net.opt_state)


def test_write_model_refuses_sharded_state(tmp_path):
    net = _net()
    pw = _fit(net, epochs=1, zero_stage=1)
    with pytest.raises(ValueError, match="gather_opt_state"):
        write_model(net, str(tmp_path / "m.zip"))
    write_model(net, str(tmp_path / "p.zip"), save_updater=False)
    pw.gather_opt_state()
    write_model(net, str(tmp_path / "m.zip"))     # now fine


# ------------------------------------------------------------- checkpoints
def _tree(net, eng):
    opt = net.opt_state if is_zero_state(net.opt_state) \
        else eng.shard_opt_state(net.opt_state)
    return {"params": net.param_dicts(), "state": net.state_dicts(),
            "opt": opt}


def test_manifest_sharding_block_and_same_mesh_restore(tmp_path):
    net = _net()
    pw = _fit(net, epochs=1, zero_stage=2)
    eng = pw._zero()
    tdc.save_sharded_checkpoint(str(tmp_path), 3, _tree(net, eng),
                                extra={"step_in_epoch": 1},
                                sharding=eng.sharding_meta())
    man = tdc.read_manifest(str(tmp_path), 3)
    assert man["sharding"]["format"] == "zero-flat"
    assert man["sharding"]["num_shards"] == 4
    assert man["sharding"]["groups"][0]["bucket_elems"]
    assert man["extra"] == {"step_in_epoch": 1}
    like = _tree(_net(), eng)
    like["opt"] = eng.init_opt_state()
    got = tdc.restore_sharded_checkpoint(str(tmp_path), 3, like)
    for a, b in zip(tdc.tree_flatten(got["opt"])[0],
                    tdc.tree_flatten(net.opt_state)[0]):
        assert torch.equal(a, b)
    for a, b in zip(tdc.tree_flatten(got["params"])[0],
                    tdc.tree_flatten(net.param_dicts())[0]):
        assert torch.equal(a, b)


def _reshard_to(tmp_path, net, eng_from, steps, truncate=False):
    eng2 = ZeroUpdateEngine.from_net(net, _mesh(2), stage=2)
    like = {"params": net.param_dicts(), "state": net.state_dicts(),
            "opt": eng2.init_opt_state()}
    if truncate:
        newest = os.path.join(str(tmp_path), f"ckpt_step{steps[-1]}_p000.npz")
        with open(newest, "r+b") as f:
            f.truncate(40)
    step, got, _ = tdc.restore_latest_sharded_checkpoint(
        str(tmp_path), like, resharder=make_zero_resharder(eng2))
    return step, got, eng2


def test_reshard_restore_onto_smaller_mesh(tmp_path):
    """A state saved on 4 workers restores onto 2 through the resharder
    (all-gather, re-slice): unsharding both gives the same state, bitwise;
    a direct restore of the 4-worker save onto 2 is refused."""
    net = _net()
    pw = _fit(net, epochs=1, zero_stage=2)
    eng4 = pw._zero()
    tdc.save_sharded_checkpoint(str(tmp_path), 5, _tree(net, eng4),
                                sharding=eng4.sharding_meta())
    step, got, eng2 = _reshard_to(tmp_path, net, eng4, [5])
    assert step == 5
    eng2.check_state(got["opt"])
    a = eng4.unshard_opt_state(net.opt_state)
    b = eng2.unshard_opt_state(got["opt"])
    assert _same(tdc.tree_flatten(a)[0], tdc.tree_flatten(b)[0])
    like = {"params": net.param_dicts(), "state": net.state_dicts(),
            "opt": eng2.init_opt_state()}
    with pytest.raises(ValueError, match="topology"):
        tdc.restore_sharded_checkpoint(str(tmp_path), 5, like)


def test_reshard_restore_falls_back_past_truncated_newest(tmp_path):
    net = _net()
    pw = _fit(net, epochs=1, zero_stage=2)
    eng4 = pw._zero()
    tdc.save_sharded_checkpoint(str(tmp_path), 5, _tree(net, eng4),
                                sharding=eng4.sharding_meta())
    pw.fit(_it(), epochs=1)
    tdc.save_sharded_checkpoint(str(tmp_path), 9, _tree(net, eng4),
                                sharding=eng4.sharding_meta())
    step, got, eng2 = _reshard_to(tmp_path, net, eng4, [5, 9], truncate=True)
    assert step == 5
    eng2.check_state(got["opt"])


def test_a_jax_zero_save_restores_into_the_port(tmp_path):
    """The reference's sharded save of its ZeRO state (8 devices, one
    block a device) restores into the port's tree of the same layout, and
    re-shards onto 4 logical workers; the state equals the reference's,
    bitwise."""
    jnet = _jnet()
    jm8 = jmesh.make_mesh((8,), ("data",), jax.devices()[:8])
    jpw = JPW(jnet, mesh=jm8, zero_stage=2)
    jpw.fit(JIter(features=X, labels=Y, batch_size=64), epochs=1)
    jeng = jpw._zero()
    jdc.save_sharded_checkpoint(str(tmp_path), 2,
                                {"params": jnet.params, "state": jnet.state,
                                 "opt": jnet.opt_state},
                                sharding=jeng.sharding_meta())
    net = _net()
    eng8 = ZeroUpdateEngine.from_net(net, _mesh(8), stage=2)
    like = {"params": net.param_dicts(), "state": net.state_dicts(),
            "opt": eng8.init_opt_state()}
    step, got, _ = tdc.restore_latest_sharded_checkpoint(
        str(tmp_path), like, resharder=make_zero_resharder(eng8))
    assert step == 2
    for a, b in zip(tdc.tree_flatten(got["opt"])[0],
                    jax.tree.leaves(jnet.opt_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        torch.cat([got["params"][i][k].reshape(-1)
                   for i in sorted(got["params"])
                   for k in sorted(got["params"][i])]).numpy(),
        np.asarray(jnet.params_flat()))
    eng4 = ZeroUpdateEngine.from_net(net, _mesh(4), stage=2)
    like["opt"] = eng4.init_opt_state()
    _, got4, _ = tdc.restore_latest_sharded_checkpoint(
        str(tmp_path), like, resharder=make_zero_resharder(eng4))
    a = eng8.unshard_opt_state(got["opt"])
    b = eng4.unshard_opt_state(got4["opt"])
    assert _same(tdc.tree_flatten(a)[0], tdc.tree_flatten(b)[0])


def test_zero_converges():
    net = _net()
    s0 = net.score(X, Y)
    _fit(net, epochs=6, zero_stage=2)
    assert net.score(X, Y) < s0
    assert net.evaluate(X, Y).accuracy() > 0.8
