"""The model axis of the parallel layer (``parallel/tensor_parallel.py``
and ``ParallelWrapper(mesh_shape=(d, m))``) against the JAX package's, at
the reference tests' sizes (``tests/test_tensor_parallel.py:30-41``: d 16,
4 heads, 1 block, V 29): the spec trees, ``(4, 1)`` bitwise ``(4,)``,
``(2, 2)`` within 1e-4 of the JAX ``(2, 2)`` run and of the port's
``(4,)`` (also with windows and ZeRO-2, and with ``overlap_sync``), the
per-rank rows and their bytes, the refusals, and a zip that the JAX
package restores bitwise. Each JAX run is a module-scoped fixture."""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo_extra import (
    text_generation_lstm as jtext_generation_lstm,
    transformer_lm as jtransformer_lm)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import build_param_specs as jspecs
from deeplearning4j_tpu.parallel import host_gather as jhost_gather
from deeplearning4j_tpu.util.serialization import restore_computation_graph
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.models.zoo_extra import (text_generation_lstm,
                                                       transformer_lm)
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                               build_param_specs,
                                               host_gather,
                                               per_replica_bytes,
                                               sharded_leaf_count)
from deeplearning4j_tpu_torch.parallel.data_parallel import (
    flat_opt_state_order, flat_param_order)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    COLUMN, ROW, held_specs, place_net, tree_specs)
from deeplearning4j_tpu_torch.util.serialization import write_model

V = 29


def _cfg(d_model=16, n_heads=4):
    return dict(vocab_size=V, d_model=d_model, n_heads=n_heads, n_blocks=1,
                max_length=16, token_input=True)


def _jnet(seed=11, **kw):
    return jtransformer_lm(**_cfg(**kw), seed=seed).init()


def _pnet(jnet, **kw):
    net = transformer_lm(**_cfg(**kw), device="cpu").init()
    load_jax_params(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in jnet.params])
    return net


def _feed(n=2, b=8, t=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rs.randint(1, V, (b, t)).astype(np.int32)
        y = np.eye(V)[rs.randint(0, V, (b, t))].astype(np.float32)
        out.append((x, y))
    return out


def _jdata():
    return [JDataSet(x, y) for x, y in _feed()]


def _pdata():
    return [DataSet(x, y) for x, y in _feed()]


def _pflat(net):
    tree = net.param_dicts()
    whole = host_gather(tree, tree_specs(net, tree))
    return np.concatenate([whole[g][k].numpy().ravel()
                           for g, k, _ in flat_param_order(net)])


def _holds_rows(net):
    return any(s for sd in held_specs(net).values() for s in sd.values())


def _jflat(net):
    return np.concatenate([np.asarray(l).ravel() for l in
                           jax.tree.leaves(jhost_gather(net.params))])


def _spec_tree(jnet, net, m):
    """The JAX spec tree as the port's {group: {name: tuple}}."""
    names = (list(net.param_dicts()) if hasattr(net, "vertex_names")
             else list(range(len(net.layers))))
    return {g: ({k: tuple(s) for k, s in sd.items()}
                if isinstance(sd, dict) else {})
            for g, sd in zip(names, jspecs(jnet, m))}


# ------------------------------------------------------------ spec trees
@pytest.mark.parametrize("model", ["transformer", "indivisible", "lstm"])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_spec_trees_equal_the_references(model, m):
    """``build_param_specs`` gives the reference's tree at every axis size,
    a leaf whose dimension does not divide falling back alone (d 18, 3
    heads), the LSTM's gate columns sharded."""
    if model == "lstm":
        jnet = jtext_generation_lstm(vocab_size=20, hidden=16).init()
        net = text_generation_lstm(20, hidden=16, device="cpu").init()
    else:
        kw = dict(d_model=18, n_heads=3) if model == "indivisible" else {}
        jnet = _jnet(**kw)
        net = _pnet(jnet, **kw)
    got = build_param_specs(net, m)
    assert got == _spec_tree(jnet, net, m)
    assert (sharded_leaf_count(got) == 0) == (m == 1)
    if m > 1:
        place_net(net, m)
        # the table reads global shapes: a network holding rows gives it
        assert build_param_specs(net, m) == got


def test_rows_hold_one_ranks_slice_and_the_forward_is_the_networks():
    jnet = _jnet()
    net = _pnet(jnet)
    x = torch.as_tensor(np.random.RandomState(3).randint(1, V, (2, 8)))
    want = net.output(x).detach().clone()
    flat = net.params_flat().clone()
    full_bytes = per_replica_bytes(net.param_dicts())
    assert place_net(net, 2) == 7
    net = net.clone()            # a copy keeps the layout: it is the shape
    # the flat vector is the global leaves', whatever the layout
    assert torch.equal(net.params_flat(), flat)
    net.set_params_flat(flat)
    assert torch.equal(net.params_flat(), flat)
    attn = net.param_dicts()["b0_attn"]
    held = held_specs(net)["b0_attn"]
    assert tuple(attn["Wq"].shape) == (2, 16, 8) and held["Wq"] == COLUMN
    assert tuple(attn["Wo"].shape) == (2, 8, 16) and held["Wo"] == ROW
    assert held["b"] == ()
    np.testing.assert_allclose(net.output(x).detach().numpy(), want.numpy(),
                               atol=1e-6)
    tree = net.param_dicts()
    assert per_replica_bytes(tree, tree_specs(net, tree)) < full_bytes
    place_net(net, 1)            # whole again, bitwise
    assert not _holds_rows(net)
    assert torch.equal(net.output(x), want)


# ------------------------------------------------------- training parity
@pytest.fixture(scope="module")
def jax_runs():
    """The JAX ``(2, 2)`` and ``(4,)`` runs from one start, and that start."""
    start = _jnet()
    weights = [{k: np.asarray(v) for k, v in p.items()} for p in start.params]
    out = {"weights": weights}
    for shape in ((2, 2), (4,)):
        net = _jnet()
        JPW(net, mesh_shape=shape).fit(_jdata(), epochs=1)
        out[shape] = _jflat(net)
    return out


def _port_run(jax_runs, shape, **kw):
    net = transformer_lm(**_cfg(), device="cpu").init()
    load_jax_params(net, jax_runs["weights"])
    pw = ParallelWrapper(net, mesh_shape=shape, **kw)
    pw.fit(_pdata(), epochs=1)
    return net, pw


@pytest.fixture(scope="module")
def port_4(jax_runs):
    torch.use_deterministic_algorithms(True)
    try:
        return _pflat(_port_run(jax_runs, (4,))[0])
    finally:
        torch.use_deterministic_algorithms(False)


def test_4x1_is_bitwise_4(jax_runs, port_4):
    torch.use_deterministic_algorithms(True)
    try:
        net, _ = _port_run(jax_runs, (4, 1))
    finally:
        torch.use_deterministic_algorithms(False)
    assert not _holds_rows(net)
    np.testing.assert_array_equal(_pflat(net), port_4)
    assert np.max(np.abs(port_4 - jax_runs[(4,)])) < 1e-4


@pytest.mark.parametrize("kw", [
    {}, dict(steps_per_dispatch=2, zero_stage=2), dict(overlap_sync=True),
    dict(zero_stage=1)], ids=["plain", "windows_zero2", "overlap", "zero1"])
def test_2x2_tracks_jax_2x2_and_the_ports_4(jax_runs, port_4, kw):
    net, pw = _port_run(jax_runs, (2, 2), **kw)
    got = _pflat(net)
    assert np.max(np.abs(got - jax_runs[(2, 2)])) < 1e-4
    assert np.max(np.abs(got - port_4)) < 1e-4
    assert _holds_rows(net)
    if kw.get("zero_stage"):
        pw.gather_opt_state()
    # the Megatron rows, and their updater state sharded with them
    full_bytes = port_4.nbytes
    params, opt = net.param_dicts(), net.opt_state
    assert per_replica_bytes(params, tree_specs(net, params)) < full_bytes
    assert per_replica_bytes(opt, tree_specs(net, opt)) < 2 * full_bytes


def test_per_rank_bytes_at_2_and_4():
    """The bytes a rank holds: every sharded leaf 1/m, the rest whole; the
    Adam state twice the parameters'."""
    net = _pnet(_jnet())
    specs = build_param_specs(net, 2)
    whole = sum(p.numel() for p in net.parameters())
    cut = sum(p.numel() for g, pd in net.param_dicts().items()
              for k, p in pd.items() if specs[g][k])
    for m in (2, 4):
        place_net(net, m)
        want = 4 * (whole - cut + cut // m)
        params, opt = net.param_dicts(), net.opt_state
        assert per_replica_bytes(params, tree_specs(net, params)) == want
        assert per_replica_bytes(opt, tree_specs(net, opt)) == 2 * want


@pytest.mark.parametrize("kwargs,match", [
    (dict(training_mode="averaging", averaging_frequency=2), "model-axis"),
    (dict(gradient_accumulator=object()), "model-sharded"),
    (dict(mesh_shape=(2, 2, 2)), "mesh_shape")])
def test_the_refusals_are_the_references(kwargs, match):
    kw = dict(kwargs)
    kw.setdefault("mesh_shape", (2, 2))
    msgs = []
    for make, pw in ((lambda: _pnet(_jnet()), ParallelWrapper),
                     (_jnet, JPW)):
        with pytest.raises(ValueError, match=match) as e:
            pw(make(), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------- the zip
def test_a_2x2_zip_restores_bitwise_in_the_jax_package(jax_runs, tmp_path):
    """``write_model`` joins the rows and their updater state, so a zip
    written from a ``(2, 2)`` network is layout-free."""
    net, _ = _port_run(jax_runs, (2, 2))
    path = str(tmp_path / "tp.zip")
    write_model(net, path)
    back = restore_computation_graph(path)
    np.testing.assert_array_equal(_jflat(back), _pflat(net))
    opt = host_gather(net.opt_state, tree_specs(net, net.opt_state))
    want = np.concatenate([opt[g][k][sk].numpy().ravel()
                           for g, k, sk, _ in flat_opt_state_order(net)])
    got = np.concatenate([np.asarray(l).ravel()
                          for l in jax.tree.leaves(back.opt_state)])
    np.testing.assert_array_equal(got, want)
    # host_gather: the global leaves, on the host
    tree = net.param_dicts()
    gathered = host_gather(tree, tree_specs(net, tree))
    held = held_specs(net)
    for g, k, p in flat_param_order(net):
        assert gathered[g][k].device.type == "cpu"
        want = torch.cat(p.detach().unbind(0), dim=held[g][k].index(
            "model")) if held[g][k] else p.detach()
        assert torch.equal(gathered[g][k], want)
