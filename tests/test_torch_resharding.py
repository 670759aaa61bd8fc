"""Any layout to any layout (``parallel/resharding.py``) against the JAX
package's: a checkpoint saved from a ``(2, 2)`` network (per-rank rows and
their updater state) restores onto ``(4,)`` and ``(1,)`` layouts and back;
a save the JAX package wrote from its ``(2, 2)`` mesh restores through the
port's ``make_any_resharder``, and the port's through the JAX package's;
``redistribute`` is pure layout; a truncated newest save walks back past
the resharder; a ZeRO flat save delegates to the ZeRO resharder."""
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo_extra import (
    transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import build_param_specs as jspecs
from deeplearning4j_tpu.parallel import host_gather as jhost_gather
from deeplearning4j_tpu.parallel import make_any_resharder as jresharder
from deeplearning4j_tpu.parallel import shard_params as jshard
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.tensor_parallel import \
    build_opt_shardings as jopt_shardings
from deeplearning4j_tpu.util import distributed_checkpoint as jdc
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.interop.jax_params import (load_jax_opt_state,
                                                         load_jax_params)
from deeplearning4j_tpu_torch.models.zoo_extra import transformer_lm
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                               build_param_specs,
                                               make_any_resharder, make_mesh,
                                               redistribute)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    COLUMN, ROW, VECTOR, full, is_rows, place_net, rows_cut, tree_specs)
from deeplearning4j_tpu_torch.parallel.zero import ZeroUpdateEngine
from deeplearning4j_tpu_torch.util.distributed_checkpoint import (
    restore_latest_sharded_checkpoint, save_sharded_checkpoint, tree_flatten)

V = 29
CFG = dict(vocab_size=V, d_model=16, n_heads=4, n_blocks=1, max_length=16,
           token_input=True)


def _feed(n=2, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(1, V, (8, 8)).astype(np.int32),
             np.eye(V)[rs.randint(0, V, (8, 8))].astype(np.float32))
            for _ in range(n)]


@pytest.fixture(scope="module")
def base():
    """A JAX net after a short (2, 1) fit (nontrivial parameters and Adam
    state) and the port's copy of it on the CPU."""
    jnet = jtransformer_lm(**CFG, seed=11).init()
    JPW(jnet, mesh_shape=(2, 1)).fit([JDataSet(x, y) for x, y in _feed()],
                                     epochs=1)
    return jnet, _port_copy(jnet)


def _port_copy(jnet):
    net = transformer_lm(**CFG, device="cpu").init()
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    load_jax_opt_state(net, [{k: {s: np.asarray(a) for s, a in st.items()}
                              for k, st in p.items()}
                             for p in jnet.opt_state],
                       iteration_count=int(jnet.iteration_count))
    return net


def _tree(net):
    """{"params", "opt"} as the JAX tree: a tuple over the vertices."""
    names = list(net.param_dicts())
    return {"params": tuple(net.param_dicts()[n] for n in names),
            "opt": tuple(net.opt_state[n] for n in names)}


def _save(d, step, net, **kw):
    """``save_sharded_checkpoint`` of ``_tree(net)`` with its layout."""
    tree = _tree(net)
    save_sharded_checkpoint(d, step, tree, specs=tree_specs(net, tree),
                            **kw)


def _laid_out(jnet, m):
    net = _port_copy(jnet)
    place_net(net, m)
    return net


def _same(tree, want):
    """Leaf for leaf the same shape (so the same layout) and bits."""
    got, ref = tree_flatten(tree)[0], tree_flatten(want)[0]
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("src,dst", [(2, 1), (2, 4), (1, 2), (4, 2),
                                     (2, 2)])
def test_a_save_restores_onto_any_model_axis(base, tmp_path, src, dst):
    """m = 1 is the ``(4,)`` / ``(1,)`` layout (whole leaves); a save from
    one axis size restores onto another, parameters and Adam state
    bitwise, each leaf cut as the target holds it."""
    jnet, _ = base
    d = str(tmp_path / "ckpt")
    _save(d, 5, _laid_out(jnet, src), extra={"src": src})
    like = _tree(_laid_out(jnet, dst))
    want = _tree(_laid_out(jnet, dst))
    for leaf in tree_flatten(like)[0]:
        leaf.data.zero_()
    step, tree, extra = restore_latest_sharded_checkpoint(
        d, like, resharder=make_any_resharder())
    assert step == 5 and extra == {"src": src}
    _same(tree, want)


def test_a_jax_2x2_save_restores_in_the_port_and_back(base, tmp_path):
    jnet, _ = base
    mesh = jmake_mesh((2, 2), ("data", "model"), jax.devices()[:4])
    specs = jspecs(jnet, 2)
    params = jhost_gather(jnet.params)
    opt = jhost_gather(jnet.opt_state)
    placed = {"params": jshard(mesh, params, specs),
              "opt": jax.tree.map(lambda v, s: jax.device_put(v, s), opt,
                                  jopt_shardings(mesh, specs, params, opt))}
    jd = str(tmp_path / "jax")
    jdc.save_sharded_checkpoint(jd, 3, placed)
    like = _tree(_laid_out(jnet, 2))
    step, tree, _ = restore_latest_sharded_checkpoint(
        jd, like, resharder=make_any_resharder())
    assert step == 3
    _same(tree, _tree(_laid_out(jnet, 2)))
    # the port's (2, 2) save restores in the JAX package onto (4, 1)
    pd = str(tmp_path / "port")
    _save(pd, 4, _laid_out(jnet, 2))
    jlike = {"params": params, "opt": opt}
    step, jtree, _ = jdc.restore_latest_sharded_checkpoint(
        pd, jlike, resharder=jresharder())
    assert step == 4
    for a, b in zip(jax.tree.leaves(jhost_gather(jtree)),
                    jax.tree.leaves({"params": params, "opt": opt})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_redistribute_is_pure_layout(base):
    _, net = base
    whole = {g: {k: p.detach().clone() for k, p in pd.items()}
             for g, pd in net.param_dicts().items()}
    specs = build_param_specs(net, 2)
    rows = redistribute(whole, make_mesh((2, 2), ("data", "model"), "cpu"),
                        specs)
    for g, sd in specs.items():
        for k, s in sd.items():
            want = (1 if s == COLUMN else 0 if s in (ROW, VECTOR) else None)
            assert rows_cut(rows[g][k].shape, whole[g][k].shape) == want
            assert is_rows(rows[g][k], s) == (want is not None)
            assert torch.equal(full(rows[g][k], s), whole[g][k])
    back = redistribute(rows, make_mesh((4,), ("data",), "cpu"),
                        build_param_specs(net, 1), layout=specs)
    for g, pd in whole.items():
        for k, t in pd.items():
            assert back[g][k].shape == t.shape
            assert torch.equal(back[g][k], t)


def test_a_truncated_newest_save_walks_back(base, tmp_path):
    jnet, _ = base
    d = str(tmp_path / "ckpt")
    _save(d, 1, _laid_out(jnet, 2))
    _save(d, 2, _laid_out(jnet, 2))
    shard = os.path.join(d, "ckpt_step2_p000.npz")
    with open(shard, "rb") as f:
        head = f.read(64)
    with open(shard, "wb") as f:
        f.write(head)
    step, tree, _ = restore_latest_sharded_checkpoint(
        d, _tree(_laid_out(jnet, 1)), resharder=make_any_resharder())
    assert step == 1
    _same(tree, _tree(_laid_out(jnet, 1)))
    # a save whose leaves do not line up with ``like`` restores nothing
    like = {"params": _tree(_laid_out(jnet, 1))["params"]}
    assert restore_latest_sharded_checkpoint(
        d, like, resharder=make_any_resharder())[0] is None


def test_a_zero_flat_save_delegates_to_the_zero_resharder(tmp_path):
    """A ZeRO-2 ``(4,)`` run's flat state, saved with its layout, restores
    onto 2 workers through ``make_any_resharder(engine)``, the gathered
    state the same."""
    jnet = jtransformer_lm(**CFG, seed=11).init()
    net = _port_copy(jnet)
    pw = ParallelWrapper(net, mesh_shape=(4,), zero_stage=2)
    pw.fit([DataSet(x, y) for x, y in _feed()], epochs=1)
    d = str(tmp_path / "zero")
    save_sharded_checkpoint(d, 2, {"params": net.param_dicts(),
                                   "opt": net.opt_state},
                            sharding=pw._zero().sharding_meta())
    eng2 = ZeroUpdateEngine.from_net(net, make_mesh((2,), ("data",), "cpu"),
                                     stage=2)
    step, tree, _ = restore_latest_sharded_checkpoint(
        d, {"params": net.param_dicts(), "opt": eng2.init_opt_state()},
        resharder=make_any_resharder(eng2))
    assert step == 2
    got = tree_flatten(eng2.unshard_opt_state(tree["opt"]))[0]
    want = tree_flatten(pw._zero().unshard_opt_state(net.opt_state))[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
