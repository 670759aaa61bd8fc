"""Java DL4J model zips in the port (``interop/dl4j_zip.py``) against the
JAX package's importer, one counterpart for each test of
``tests/test_dl4j_interop.py``.

Each import reads the same zip in both packages. Parameters and layer
state are equal bitwise (both copy the same float32 buffer), outputs agree
within 1e-5 and with the reference test's plain-numpy oracles at its
tolerances, ``import_notes`` are equal string for string, and an imported
Nesterovs momentum ``v`` equals the JAX leaf of the same parameter. Every
port network is built on the CPU (``device="cpu"``)."""
import _torch_threads  # noqa: F401
import io
import json
import os
import struct
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.interop import dl4j_zip as jz
from deeplearning4j_tpu.util.serialization import restore_model as jrestore
from deeplearning4j_tpu_torch.interop import (import_dl4j_zip, is_dl4j_zip,
                                              read_nd4j_array,
                                              write_nd4j_array)
from deeplearning4j_tpu_torch.util.serialization import restore_model

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "dl4j")
MLP = os.path.join(FIX, "080_mlp_3_4_5.zip")
LENET = os.path.join(FIX, "080_lenet_flat_8x8.zip")
GRAVES = os.path.join(FIX, "080_graves_char_rnn.zip")


def _both(path, **kw):
    """The same zip through both importers (the port's on the CPU)."""
    return jz.import_dl4j_zip(str(path), **kw), \
        import_dl4j_zip(str(path), device="cpu", **kw)


def _assert_same_import(jnet, tnet):
    """Parameters and layer state bitwise, the same notes, and every
    updater-state buffer equal to the JAX leaf of its parameter."""
    tparams, tstate = tnet.param_dicts(), tnet.state_dicts()
    assert len(jnet.params) == len(tparams)
    for i, (jp, js) in enumerate(zip(jnet.params, jnet.state)):
        assert set(jp) == set(tparams[i]), (i, set(jp), set(tparams[i]))
        for k, v in jp.items():
            np.testing.assert_array_equal(
                tparams[i][k].detach().numpy(), np.asarray(v),
                err_msg=f"layer {i} param {k}")
        for k, v in js.items():
            np.testing.assert_array_equal(
                tstate[i][k].numpy(), np.asarray(v),
                err_msg=f"layer {i} state {k}")
    assert tnet.import_notes == jnet.import_notes
    for i, layer in enumerate(jnet.opt_state):
        for pname, st in layer.items():
            assert set(st) == set(tnet.opt_state[i][pname])
            for sname, v in st.items():
                np.testing.assert_array_equal(
                    tnet.opt_state[i][pname][sname].numpy(), np.asarray(v),
                    err_msg=f"layer {i} {pname} state {sname}")


def _outputs(jnet, tnet, x):
    return (np.asarray(jnet.output(x)),
            tnet.output(torch.as_tensor(x)).detach().numpy())


def _softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


# ------------------------------------------------------- Nd4j binary layer
@pytest.mark.parametrize("order", ["c", "f"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_nd4j_buffer_round_trip(order, dtype):
    """Both writers give the same bytes; each reader reads the other's."""
    r = np.random.default_rng(3)
    a = (r.normal(size=(4, 5)) * 10).astype(dtype)
    blob = write_nd4j_array(a, order=order)
    assert blob == jz.write_nd4j_array(a, order=order)
    np.testing.assert_array_equal(read_nd4j_array(blob), a)
    np.testing.assert_array_equal(read_nd4j_array(blob), jz.read_nd4j_array(blob))


def test_nd4j_long_length_variant():
    """Some nd4j releases write the DataBuffer length as int64; the reader
    auto-detects by validating the dtype token that follows."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    blob = write_nd4j_array(a, order="c")
    out, off = io.BytesIO(), 0
    for _ in range(2):                       # shape-info buffer, data buffer
        n_utf = struct.unpack_from(">H", blob, off)[0]
        out.write(blob[off:off + 2 + n_utf])
        off += 2 + n_utf
        (n,) = struct.unpack_from(">i", blob, off)
        out.write(struct.pack(">q", n))
        off += 4
        n_utf2 = struct.unpack_from(">H", blob, off)[0]
        name = blob[off + 2:off + 2 + n_utf2].decode()
        out.write(blob[off:off + 2 + n_utf2])
        off += 2 + n_utf2
        itemsize = {"INT": 4, "FLOAT": 4}[name]
        out.write(blob[off:off + n * itemsize])
        off += n * itemsize
    long_blob = out.getvalue()
    np.testing.assert_array_equal(read_nd4j_array(long_blob), a)
    np.testing.assert_array_equal(read_nd4j_array(long_blob),
                                  jz.read_nd4j_array(long_blob))


# ------------------------------------------------------------- MLP fixture
def test_mlp_restore_architecture_and_params():
    """RegressionTest080.regressionTestMLP1's facts through ``restore_model``
    in both packages: layer types, sizes and activations, Nesterovs(0.15,
    0.9), params == linspace(1..N) and the momentum == linspace(1..N),
    each by parameter name."""
    assert is_dl4j_zip(MLP) and jz.is_dl4j_zip(MLP)
    assert not is_dl4j_zip(os.path.join(FIX, "graves_raw_weights.npy"))
    jnet, net = jrestore(MLP), restore_model(MLP, device="cpu")
    _assert_same_import(jnet, net)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs

    l0, l1 = net.conf.layers
    assert type(l0) is DenseLayer and l0.n_in == 3 and l0.n_out == 4
    assert l0.activation == "relu"
    assert type(l1) is OutputLayer and l1.n_in == 4 and l1.n_out == 5
    assert l1.activation == "softmax" and l1.loss == "mcxent"
    u = net.conf.updater
    assert isinstance(u, Nesterovs)
    assert u.learning_rate == pytest.approx(0.15)
    assert u.momentum == pytest.approx(0.9)
    assert net.device == torch.device("cpu")

    n = 3 * 4 + 4 + 4 * 5 + 5
    flat = np.linspace(1, n, n).astype(np.float32)
    want = {(0, "W"): flat[0:12].reshape((3, 4), order="F"),
            (0, "b"): flat[12:16],
            (1, "W"): flat[16:36].reshape((4, 5), order="F"),
            (1, "b"): flat[36:41]}
    params = net.param_dicts()
    for (i, k), arr in want.items():
        np.testing.assert_array_equal(params[i][k].detach().numpy(), arr)
        np.testing.assert_array_equal(net.opt_state[i][k]["v"].numpy(), arr)


def test_mlp_predict_matches_numpy_oracle():
    jnet, net = _both(MLP)
    n = 41
    flat = np.linspace(1, n, n).astype(np.float32)
    W0 = flat[0:12].reshape((3, 4), order="F")
    b0 = flat[12:16]
    W1 = flat[16:36].reshape((4, 5), order="F")
    b1 = flat[36:41]
    x = np.random.default_rng(0).normal(size=(7, 3)).astype(np.float32)
    expect = _softmax(np.maximum(x @ W0 + b0, 0.0) @ W1 + b1)
    jout, out = _outputs(jnet, net, x)
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, expect, atol=1e-5)


# ----------------------------------------------------------- LeNet fixture
def _numpy_lenet(x_flat):
    """Independent forward pass for the LeNet fixture: explicit loops, no
    shared code with the importer (the reference test's oracle)."""
    w = np.load(os.path.join(FIX, "lenet_raw_weights.npy"),
                allow_pickle=True).item()
    B = x_flat.shape[0]
    x = x_flat.reshape(B, 1, 8, 8)          # DL4J NCHW flattening
    convW, convb = w["convW"], w["convb"]   # [out,in,kh,kw]
    conv = np.zeros((B, 4, 6, 6), np.float32)
    for o in range(4):
        for i in range(6):
            for j in range(6):
                patch = x[:, 0, i:i + 3, j:j + 3]
                conv[:, o, i, j] = (patch * convW[o, 0]).sum(axis=(1, 2)) \
                    + convb[o]
    conv = np.maximum(conv, 0.0)
    pool = conv.reshape(B, 4, 3, 2, 3, 2).max(axis=(3, 5))   # 2x2 max
    flat = pool.reshape(B, -1)              # NCHW flatten: c, h, w
    h = np.maximum(flat @ w["dW"] + w["db"], 0.0)
    return _softmax(h @ w["oW"] + w["ob"])


def test_lenet_restore_and_predict_parity():
    """The 'c' [out,in,kh,kw] -> [kh,kw,in,out] conv transpose and the
    cnnToFeedForward row permutation, against the loop-based oracle."""
    jnet, net = _both(LENET)
    _assert_same_import(jnet, net)
    x = np.random.default_rng(1).normal(size=(5, 64)).astype(np.float32)
    jout, out = _outputs(jnet, net, x)
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, _numpy_lenet(x), atol=1e-4)


def test_unsupported_layer_is_a_clear_error(tmp_path):
    conf = {"confs": [{"layer": {"RBM": {"activationFunction": "sigmoid",
                                         "nin": 3, "nout": 4}}}]}
    p = tmp_path / "bad.zip"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin", b"")
    with pytest.raises(ValueError, match="unsupported DL4J layer") as je:
        jz.import_dl4j_zip(str(p))
    with pytest.raises(ValueError, match="unsupported DL4J layer") as te:
        import_dl4j_zip(str(p), device="cpu")
    assert str(te.value) == str(je.value)
    # a ComputationGraph zip (no 'confs') is refused by both alike
    g = tmp_path / "graph.zip"
    with zipfile.ZipFile(g, "w") as z:
        z.writestr("configuration.json", json.dumps({"vertices": {}}))
        z.writestr("coefficients.bin", b"")
    with pytest.raises(ValueError, match="ComputationGraph import") as je:
        jz.import_dl4j_zip(str(g))
    with pytest.raises(ValueError, match="ComputationGraph import") as te:
        import_dl4j_zip(str(g), device="cpu")
    assert str(te.value) == str(je.value)


# ------------------------------------------------------ GravesLSTM fixture
def _numpy_graves_lstm(x):
    """Independent DL4J-semantics LSTM forward, straight from the JAVA
    layout (LSTMHelpers.java): gate columns (g, f, o, i) and peephole
    columns (wFF, wOO, wGG) = (forget, output, input-gate)."""
    w = np.load(os.path.join(FIX, "graves_raw_weights.npy"),
                allow_pickle=True).item()
    W, RW, b, oW, ob = w["W"], w["RW"], w["b"], w["oW"], w["ob"]
    B, T, _ = x.shape
    h = RW.shape[0]
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    R4 = RW[:, :4 * h]
    wFF, wOO, wGG = RW[:, 4 * h], RW[:, 4 * h + 1], RW[:, 4 * h + 2]
    hs = np.zeros((B, T, h), np.float32)
    hp = np.zeros((B, h), np.float32)
    cp = np.zeros((B, h), np.float32)
    for t in range(T):
        z = x[:, t] @ W + hp @ R4 + b            # [B, 4H], (g,f,o,i)
        zg, zf, zo, zi = (z[:, :h], z[:, h:2*h], z[:, 2*h:3*h], z[:, 3*h:])
        f = sig(zf + cp * wFF)
        i = sig(zi + cp * wGG)
        c = f * cp + i * np.tanh(zg)
        o = sig(zo + c * wOO)
        hp, cp = o * np.tanh(c), c
        hs[:, t] = hp
    return _softmax(hs @ oW + ob)


def test_graves_lstm_restore_and_predict_parity():
    """The gate order (g,f,o,i)->(i,f,o,g) and the peephole columns,
    against a from-the-Java-layout numpy forward."""
    jnet, net = _both(GRAVES)
    _assert_same_import(jnet, net)
    from deeplearning4j_tpu_torch.nn.layers import GravesLSTM
    assert type(net.conf.layers[0]) is GravesLSTM
    x = np.random.default_rng(2).normal(size=(3, 6, 5)).astype(np.float32)
    jout, out = _outputs(jnet, net, x)
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, _numpy_graves_lstm(x), atol=2e-4)


def test_lstm_updater_state_lands_on_correct_leaves(tmp_path):
    """With nIn == nOut every shape coincides, so a wrong pairing would
    pass a shape guard: each momentum buffer is pinned to its parameter
    by name, and equals the JAX package's leaf of that parameter."""
    nin = h = 4
    lstm = {"layerName": "l0", "activationFunction": "tanh", "nin": nin,
            "nout": h, "updater": "NESTEROVS", "learningRate": 0.1,
            "momentum": 0.9, "l1": 0.0, "l2": 0.0, "dropOut": 0.0}
    conf = {"backprop": True, "confs": [
        {"seed": 1, "pretrain": False, "layer": {"gravesLSTM": lstm}}]}
    n = nin * 4 * h + h * (4 * h + 3) + 4 * h
    params = np.arange(1, n + 1, dtype=np.float32)
    upd = np.arange(1001, 1001 + n, dtype=np.float32)
    p = tmp_path / "lstm.zip"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin",
                   write_nd4j_array(params.reshape(1, -1), order="c"))
        z.writestr("updaterState.bin",
                   write_nd4j_array(upd.reshape(1, -1), order="c"))
    jnet, net = _both(p)
    assert not net.import_notes, net.import_notes
    _assert_same_import(jnet, net)

    def gates(a):
        return np.concatenate([a[..., 3*h:4*h], a[..., h:2*h],
                               a[..., 2*h:3*h], a[..., 0:h]], axis=-1)

    def split(flat):
        W = gates(flat[:nin*4*h].reshape((nin, 4*h), order="F"))
        RW = flat[nin*4*h:nin*4*h + h*(4*h+3)].reshape((h, 4*h+3), order="F")
        return {"W": W, "R": gates(RW[:, :4*h]), "b": gates(flat[-4*h:]),
                "pf": RW[:, 4*h], "po": RW[:, 4*h+1], "pi": RW[:, 4*h+2]}

    want_p, want_u = split(params), split(upd)
    for name in want_p:
        np.testing.assert_array_equal(
            net.param_dicts()[0][name].detach().numpy(), want_p[name],
            err_msg=f"param {name}")
        np.testing.assert_array_equal(
            net.opt_state[0][name]["v"].numpy(), want_u[name],
            err_msg=f"momentum {name}")


def test_batchnorm_restore_params_and_running_stats(tmp_path):
    """gamma/beta land in the parameters and the running mean/var in the
    layer state; inference against the closed-form numpy BN."""
    nf = 6
    r = np.random.default_rng(4)
    gamma = r.normal(1, 0.1, nf).astype(np.float32)
    beta = r.normal(0, 0.1, nf).astype(np.float32)
    mean = r.normal(0, 1, nf).astype(np.float32)
    var = r.uniform(0.5, 2.0, nf).astype(np.float32)
    W = r.normal(0, 0.3, (4, nf)).astype(np.float32)
    b = r.normal(0, 0.1, nf).astype(np.float32)
    oW = r.normal(0, 0.3, (nf, 3)).astype(np.float32)
    ob = r.normal(0, 0.1, 3).astype(np.float32)
    conf = {"backprop": True, "confs": [
        {"seed": 1, "pretrain": False, "layer": {"dense": {
            "activationFunction": "identity", "nin": 4, "nout": nf,
            "updater": "NESTEROVS", "learningRate": 0.1, "momentum": 0.9}}},
        {"seed": 1, "pretrain": False, "layer": {"batchNormalization": {
            "nin": nf, "nout": nf, "decay": 0.9, "eps": 1e-5,
            "activationFunction": "relu"}}},
        {"seed": 1, "pretrain": False, "layer": {"output": {
            "activationFunction": "softmax", "lossFunction": "MCXENT",
            "nin": nf, "nout": 3}}},
    ]}
    flat = np.concatenate([W.ravel(order="F"), b, gamma, beta, mean, var,
                           oW.ravel(order="F"), ob]).astype(np.float32)
    p = tmp_path / "bn.zip"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin",
                   write_nd4j_array(flat.reshape(1, -1), order="c"))
    jnet, net = _both(p)
    _assert_same_import(jnet, net)
    np.testing.assert_array_equal(
        net.param_dicts()[1]["gamma"].detach().numpy(), gamma)
    np.testing.assert_array_equal(net.state_dicts()[1]["mean"].numpy(), mean)
    x = r.normal(size=(5, 4)).astype(np.float32)
    y = np.maximum((x @ W + b - mean) / np.sqrt(var + 1e-5) * gamma + beta,
                   0.0)
    jout, out = _outputs(jnet, net, x)
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, _softmax(y @ oW + ob), atol=1e-5)


def test_graves_bidirectional_restore_and_predict_parity(tmp_path):
    """Forward (W,RW,b) then backward (W,RW,b), each GravesLSTM-shaped;
    DL4J sums the directions. Oracle: the numpy Graves cell both ways."""
    nin, h, nout = 3, 5, 2
    r = np.random.default_rng(11)

    def direction():
        return (r.normal(0, 0.3, (nin, 4 * h)).astype(np.float32),
                r.normal(0, 0.3, (h, 4 * h + 3)).astype(np.float32),
                r.normal(0, 0.1, (4 * h,)).astype(np.float32))

    Wf, RWf, bf = direction()
    Wb, RWb, bb = direction()
    oW = r.normal(0, 0.3, (h, nout)).astype(np.float32)
    ob = r.normal(0, 0.1, (nout,)).astype(np.float32)
    conf = {"backprop": True, "confs": [
        {"seed": 1, "pretrain": False, "layer": {"gravesBidirectionalLSTM": {
            "activationFunction": "tanh", "nin": nin, "nout": h,
            "updater": "SGD", "learningRate": 0.1}}},
        {"seed": 1, "pretrain": False, "layer": {"rnnoutput": {
            "activationFunction": "softmax", "lossFunction": "MCXENT",
            "nin": h, "nout": nout}}}]}
    flat = np.concatenate([
        Wf.ravel(order="F"), RWf.ravel(order="F"), bf,
        Wb.ravel(order="F"), RWb.ravel(order="F"), bb,
        oW.ravel(order="F"), ob]).astype(np.float32)
    p = tmp_path / "bi.zip"
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin",
                   write_nd4j_array(flat.reshape(1, -1), order="c"))
    jnet, net = _both(p)
    _assert_same_import(jnet, net)
    from deeplearning4j_tpu_torch.nn.layers import GravesBidirectionalLSTM
    assert type(net.conf.layers[0]) is GravesBidirectionalLSTM

    def cell(x, W, RW, b):        # DL4J-layout numpy Graves cell
        sig = lambda z: 1.0 / (1.0 + np.exp(-z))
        R4, wFF, wOO, wGG = (RW[:, :4*h], RW[:, 4*h], RW[:, 4*h+1],
                             RW[:, 4*h+2])
        B, T = x.shape[:2]
        hs = np.zeros((B, T, h), np.float32)
        hp = np.zeros((B, h), np.float32)
        cp = np.zeros((B, h), np.float32)
        for t in range(T):
            z = x[:, t] @ W + hp @ R4 + b
            zg, zf, zo, zi = (z[:, :h], z[:, h:2*h], z[:, 2*h:3*h],
                              z[:, 3*h:])
            f = sig(zf + cp * wFF)
            i = sig(zi + cp * wGG)
            c = f * cp + i * np.tanh(zg)
            o = sig(zo + c * wOO)
            hp, cp = o * np.tanh(c), c
            hs[:, t] = hp
        return hs

    x = np.random.default_rng(3).normal(size=(2, 7, nin)).astype(np.float32)
    fwd = cell(x, Wf, RWf, bf)
    bwd = cell(x[:, ::-1], Wb, RWb, bb)[:, ::-1]
    jout, out = _outputs(jnet, net, x)
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, _softmax((fwd + bwd) @ oW + ob),
                               atol=2e-4)


def _two_layer_conf(lr0=0.1, lr1=0.1, upd0="SGD", upd1="SGD"):
    mk = lambda nin, nout, upd, lr, extra: dict(
        {"layerName": "l", "activationFunction": "relu", "nin": nin,
         "nout": nout, "updater": upd, "learningRate": lr, "l1": 0.0,
         "l2": 0.0, "dropOut": 0.0}, **extra)
    return json.dumps({"backprop": True, "confs": [
        {"seed": 1, "pretrain": False,
         "layer": {"dense": mk(3, 4, upd0, lr0, {})}},
        {"seed": 1, "pretrain": False,
         "layer": {"output": mk(4, 5, upd1, lr1,
                                {"activationFunction": "softmax",
                                 "lossFunction": "MCXENT"})}}]})


def _write_two_layer_zip(path, conf_json, updater_state=False):
    n = 3 * 4 + 4 + 4 * 5 + 5
    flat = np.linspace(1, n, n, dtype=np.float32).reshape(1, -1)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("configuration.json", conf_json)
        z.writestr("coefficients.bin", write_nd4j_array(flat, order="c"))
        if updater_state:
            z.writestr("updaterState.bin", write_nd4j_array(flat, order="c"))


def test_heterogeneous_per_layer_updaters_warn_on_import(tmp_path):
    """Layers that disagree with layer 0's updater are named in
    ``import_notes``, in the reference's words; an Adam or Sgd zip with an
    updater state gets the reference's note and a fresh state."""
    p = tmp_path / "hetero.zip"
    _write_two_layer_zip(p, _two_layer_conf(lr0=0.1, lr1=0.01))
    jnet, net = _both(p)
    assert any("heterogeneous" in n for n in net.import_notes)
    _assert_same_import(jnet, net)

    p2 = tmp_path / "hetero2.zip"
    _write_two_layer_zip(p2, _two_layer_conf(upd0="NESTEROVS", upd1="ADAM"))
    jnet, net = _both(p2)
    assert any("heterogeneous" in n for n in net.import_notes)
    _assert_same_import(jnet, net)

    conf = json.loads(_two_layer_conf(upd1="ADAM"))
    for key in ("updater", "learningRate"):
        del conf["confs"][0]["layer"]["dense"][key]
    p3 = tmp_path / "hetero3.zip"
    _write_two_layer_zip(p3, json.dumps(conf))
    jnet, net = _both(p3)
    assert any("heterogeneous" in n for n in net.import_notes)
    _assert_same_import(jnet, net)

    for upd in ("ADAM", "SGD"):
        p4 = tmp_path / f"state_{upd}.zip"
        _write_two_layer_zip(p4, _two_layer_conf(upd0=upd, upd1=upd),
                             updater_state=True)
        jnet, net = _both(p4)
        assert len(net.import_notes) == 1, net.import_notes
        _assert_same_import(jnet, net)


def test_homogeneous_updaters_import_without_warning(tmp_path):
    """The common case (one updater everywhere) stays note-free, and
    ``load_updater=False`` leaves a fresh momentum."""
    p = tmp_path / "homo.zip"
    _write_two_layer_zip(p, _two_layer_conf())
    jnet, net = _both(p)
    assert not any("heterogeneous" in n for n in net.import_notes)
    _assert_same_import(jnet, net)
    jnet, net = _both(MLP, load_updater=False)
    _assert_same_import(jnet, net)
    assert float(net.opt_state[0]["W"]["v"].abs().sum()) == 0.0
