"""Import Java-era DL4J model zips into the port.

Counterpart of ``deeplearning4j_tpu/interop/dl4j_zip.py``; the host code
(the Nd4j buffers, the JSON translation, the layouts) is the same numpy,
and the network it builds is the port's. A reference model zip
(util/ModelSerializer.java:79-96) holds:
  - ``configuration.json``  — MultiLayerConfiguration.toJson (Jackson
    WRAPPER_OBJECT layer polymorphism: nn/conf/layers/Layer.java:48-70)
  - ``coefficients.bin``    — Nd4j.write of the ONE flat parameter row
    vector, layer by layer, each layer's weights as the 'f'-order view
    (nn/params/DefaultParamInitializer.java:104-105) and conv kernels as
    the 'c'-order [out, in, kh, kw] view
    (nn/params/ConvolutionParamInitializer.java:106)
  - ``updaterState.bin``    — Nd4j.write of the flat updater state view

Both the modern (0.7.2+) ``activationFn`` / ``lossFn`` object dialect and
the legacy string ``activationFunction`` / ``lossFunction`` dialect are
accepted, as the Java reader accepts both
(MultiLayerConfiguration.java:145-255).

The Nd4j binary layout (nd4j 0.x ``Nd4j.write(INDArray, DataOutputStream)``)
is two consecutive DataBuffer dumps, shape-info then data, each:

    writeUTF(allocationMode)  # "HEAP" / "DIRECT" / "JAVACPP"
    length                    # big-endian; int32 in most 0.x releases,
                              # int64 in some — both are auto-detected by
                              # validating the dtype token that follows
    writeUTF(dataTypeName)    # "INT" / "FLOAT" / "DOUBLE" / "LONG"
    <length big-endian values>

The shape-info buffer is INT: [rank, *shape, *stride, offset,
elementWiseStride, order] with order 99='c' / 102='f'.

The blocks are written into the port network's own parameters and layer
state (``param_dict()``, ``layer_state()``), cast to the network's dtype
on its device. The Nesterovs momentum is written into the updater's
named tree ``{layer: {param: {"v": ...}}}`` by parameter name.
"""
from __future__ import annotations

import io
import json
import struct
import zipfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..device import DeviceLike

CONFIG_ENTRY = "configuration.json"
PARAMS_ENTRY = "coefficients.bin"
UPDATER_ENTRY = "updaterState.bin"

_NP_DTYPES = {"FLOAT": np.dtype(">f4"), "DOUBLE": np.dtype(">f8"),
              "INT": np.dtype(">i4"), "LONG": np.dtype(">i8"),
              "HALF": np.dtype(">f2")}


# ------------------------------------------------------------ Nd4j binary
def _read_utf(buf: bytes, off: int) -> Tuple[str, int]:
    """java.io.DataOutputStream.writeUTF: u2 byte-length + modified-UTF8
    (plain ASCII for every token Nd4j writes)."""
    (n,) = struct.unpack_from(">H", buf, off)
    s = buf[off + 2:off + 2 + n].decode("utf-8")
    return s, off + 2 + n


def _write_utf(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def _read_databuffer(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    _mode, off = _read_utf(buf, off)
    # length is int32 in most releases, int64 in some: disambiguate by
    # checking that the bytes after the candidate length parse as a valid
    # dtype token (a 2-byte length in range + a known name)
    for width, fmt in ((4, ">i"), (8, ">q")):
        (n,) = struct.unpack_from(fmt, buf, off)
        if n < 0:
            continue
        try:
            name, data_off = _read_utf(buf, off + width)
        except (struct.error, UnicodeDecodeError):
            continue
        if name in _NP_DTYPES:
            dt = _NP_DTYPES[name]
            end = data_off + n * dt.itemsize
            if end <= len(buf):
                arr = np.frombuffer(buf, dt, count=n, offset=data_off)
                return arr, end
    raise ValueError("not an Nd4j DataBuffer (no valid length+dtype header)")


def read_nd4j_array(data: bytes) -> np.ndarray:
    """Parse one ``Nd4j.write`` dump: shape-info buffer + data buffer."""
    info, off = _read_databuffer(data, 0)
    info = info.astype(np.int64)
    rank = int(info[0])
    if len(info) != 2 * rank + 4:
        raise ValueError(f"shape-info length {len(info)} != 2*{rank}+4")
    shape = tuple(int(s) for s in info[1:1 + rank])
    order = chr(int(info[-1]))
    if order not in ("c", "f"):
        raise ValueError(f"unknown order byte {info[-1]}")
    flat, _ = _read_databuffer(data, off)
    if flat.size != int(np.prod(shape)):
        raise ValueError(f"data length {flat.size} != prod{shape}")
    # native byte order for downstream math
    return np.ascontiguousarray(
        flat.reshape(shape, order=order).astype(flat.dtype.newbyteorder("=")))


def write_nd4j_array(arr: np.ndarray, *, order: str = "c",
                     allocation_mode: str = "JAVACPP") -> bytes:
    """Emit the ``Nd4j.write`` layout (the fixture generator's writer, and
    the export half of the interop: a buffer written here parses with the
    Java-side Nd4j.read)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "f":
        name = "DOUBLE" if arr.dtype.itemsize == 8 else "FLOAT"
    elif arr.dtype.kind in "iu":
        name = "LONG" if arr.dtype.itemsize == 8 else "INT"
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    dt = _NP_DTYPES[name]
    rank = arr.ndim
    shape = arr.shape
    # strides in elements for the chosen logical order
    strides = []
    acc = 1
    dims = range(rank - 1, -1, -1) if order == "c" else range(rank)
    tmp = [0] * rank
    for d in dims:
        tmp[d] = acc
        acc *= shape[d]
    strides = tmp
    info = np.asarray([rank, *shape, *strides, 0, 1, ord(order)], ">i4")
    out = io.BytesIO()
    for piece in (info, np.asarray(arr.ravel(order=order), dt)):
        out.write(_write_utf(allocation_mode))
        out.write(struct.pack(">i", piece.size))
        out.write(_write_utf("INT" if piece is info else name))
        out.write(piece.tobytes())
    return out.getvalue()


# ------------------------------------------------------- config translation
_ACT_MAP = {"relu": "relu", "tanh": "tanh", "sigmoid": "sigmoid",
            "softmax": "softmax", "identity": "identity", "linear": "identity",
            "leakyrelu": "leakyrelu", "softplus": "softplus",
            "softsign": "softsign", "elu": "elu", "cube": "cube",
            "hardtanh": "hardtanh", "hardsigmoid": "hardsigmoid",
            "rationaltanh": "rationaltanh", "rectifiedtanh": "relu"}

_LOSS_MAP = {"MCXENT": "mcxent", "NEGATIVELOGLIKELIHOOD": "negativeloglikelihood",
             "MSE": "mse", "SQUARED_LOSS": "mse", "XENT": "xent",
             "L2": "l2", "L1": "l1", "MEAN_ABSOLUTE_ERROR": "mae",
             "KL_DIVERGENCE": "kl_divergence", "POISSON": "poisson",
             "COSINE_PROXIMITY": "cosine_proximity", "HINGE": "hinge",
             "SQUARED_HINGE": "squared_hinge",
             "MEAN_SQUARED_LOGARITHMIC_ERROR": "msle",
             "MEAN_ABSOLUTE_PERCENTAGE_ERROR": "mape"}


def _parse_activation(d: Dict[str, Any]) -> str:
    """Accept every dialect the Java reader accepts: legacy string
    ``activationFunction`` (pre-0.7.2), 0.8 wrapper-object ``activationFn``
    ({"ReLU": {}}), and @class-tagged objects."""
    if "activationFunction" in d and isinstance(d["activationFunction"], str):
        key = d["activationFunction"].lower()
    else:
        fn = d.get("activationFn")
        if fn is None:
            return "identity"
        if isinstance(fn, str):
            key = fn.lower()
        elif "@class" in fn:
            key = fn["@class"].rsplit(".", 1)[-1]
            key = key[len("Activation"):].lower() \
                if key.startswith("Activation") else key.lower()
        else:   # wrapper object: {"ReLU": {...}}
            key = next(iter(fn)).lower()
    if key.startswith("activation"):
        key = key[len("activation"):]
    if key not in _ACT_MAP:
        raise ValueError(f"unsupported DL4J activation {key!r}")
    return _ACT_MAP[key]


def _parse_loss(d: Dict[str, Any]) -> str:
    if "lossFunction" in d and isinstance(d["lossFunction"], str):
        enum = d["lossFunction"].upper()
        if enum in _LOSS_MAP:
            return _LOSS_MAP[enum]
        raise ValueError(f"unsupported DL4J loss {enum!r}")
    fn = d.get("lossFn")
    if fn is None:
        return "mcxent"
    key = (fn if isinstance(fn, str)
           else fn.get("@class", next(iter(fn)))).rsplit(".", 1)[-1]
    key = key[len("Loss"):] if key.startswith("Loss") else key
    if key.upper() in _LOSS_MAP:
        return _LOSS_MAP[key.upper()]
    raise ValueError(f"unsupported DL4J loss {key!r}")


def _pair(v, default) -> Tuple[int, int]:
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _updater_signature(d: Dict[str, Any]) -> tuple:
    """The updater-relevant fields of one Java layer conf (exactly the set
    _updater_from_java reads), for heterogeneity detection on import."""
    return tuple((k, d.get(k)) for k in
                 ("updater", "learningRate", "momentum", "adamMeanDecay",
                  "adamVarDecay", "rmsDecay", "rho"))


def _updater_from_java(d: Dict[str, Any]):
    """Per-layer updater fields (BaseLayer.java:48-62) -> the port's
    ``optimize.updaters`` rule."""
    from ..optimize.updaters import (AdaDelta, AdaGrad, Adam, Nesterovs,
                                     NoOp, RmsProp, Sgd)
    name = str(d.get("updater", "SGD")).upper()
    lr = float(d.get("learningRate", 0.1))
    if name == "NESTEROVS":
        return Nesterovs(lr, momentum=float(d.get("momentum", 0.9)))
    if name == "ADAM":
        return Adam(lr, beta1=float(d.get("adamMeanDecay", 0.9)),
                    beta2=float(d.get("adamVarDecay", 0.999)))
    if name == "RMSPROP":
        return RmsProp(lr, decay=float(d.get("rmsDecay", 0.95)))
    if name == "ADAGRAD":
        return AdaGrad(lr)
    if name == "ADADELTA":
        return AdaDelta(rho=float(d.get("rho", 0.95)))
    if name == "NONE":
        return NoOp()
    return Sgd(lr)


def _convert_layer(type_name: str, d: Dict[str, Any]):
    """One Java layer-conf wrapper entry -> (our LayerConf, param spec).

    The param spec drives the coefficients.bin split: a list of
    (our_param_name, dl4j_shape, dl4j_order, transpose, row_perm) in the
    exact order the Java param initializer flattens them. ``row_perm`` is
    filled in later for dense weights that sit behind a cnnToFeedForward
    boundary (the Java preprocessor flattens NCHW c,h,w; our runtime
    flattens NHWC h,w,c, so W rows must be re-indexed)."""
    from ..nn.layers import (LSTM, ActivationLayer, BatchNormalization,
                             ConvolutionLayer, DenseLayer, DropoutLayer,
                             EmbeddingLayer, GravesBidirectionalLSTM,
                             GravesLSTM, LossLayer, OutputLayer,
                             RnnOutputLayer, SubsamplingLayer)

    act = None
    try:
        act = _parse_activation(d)
    except ValueError:
        if type_name in ("subsampling", "dropout", "loss",
                         "batchNormalization"):
            act = "identity"
        else:
            raise
    nin = int(d.get("nin", d.get("nIn", 0)) or 0)
    nout = int(d.get("nout", d.get("nOut", 0)) or 0)
    dropout = float(d.get("dropOut", 0.0) or 0.0)
    common = dict(dropout=dropout)
    dense_spec = [("W", (nin, nout), "f", None, None),
                  ("b", (nout,), "c", None, None)]
    if type_name == "dense":
        return DenseLayer(n_in=nin, n_out=nout, activation=act,
                          **common), dense_spec
    if type_name == "output":
        return OutputLayer(n_in=nin, n_out=nout, activation=act,
                           loss=_parse_loss(d), **common), dense_spec
    if type_name == "rnnoutput":
        return RnnOutputLayer(n_in=nin, n_out=nout, activation=act,
                              loss=_parse_loss(d), **common), dense_spec
    if type_name == "loss":
        return LossLayer(loss=_parse_loss(d), activation=act), []
    if type_name == "embedding":
        return EmbeddingLayer(n_in=nin, n_out=nout, activation=act,
                              **common), dense_spec
    if type_name == "activation":
        return ActivationLayer(activation=act), []
    if type_name == "dropout":
        return DropoutLayer(activation=act, dropout=dropout), []
    if type_name in ("gravesLSTM", "LSTM", "gravesBidirectionalLSTM"):
        h = nout

        # DL4J's gate column order inside the 4H block is (g, f, o, i):
        # interval(0,H) is the BLOCK INPUT (layer activation) and (3H,4H)
        # the "input modulation gate" that multiplies it
        # (LSTMHelpers.java:225-301); ours is (i, f, o, g) — blocks 0 and
        # 3 swap, f and o stay put.
        def cols(a):
            return np.concatenate([a[..., 3 * h:4 * h], a[..., h:2 * h],
                                   a[..., 2 * h:3 * h], a[..., 0:h]],
                                  axis=-1)

        gate_act = "sigmoid"
        if d.get("gateActivationFn") is not None:
            gate_act = _parse_activation(
                {"activationFn": d["gateActivationFn"]})
        # recurrent matrix [H, 4H+3] 'f': the 3 extra columns are the
        # peepholes, applied as (forget, output, input-gate) —
        # wFF/wOO/wGG at LSTMHelpers.java:112-119, 230, 254, 297
        def triplet(sfx=""):
            def conv_w(w, sfx=sfx):
                return {f"W{sfx}": cols(w)}

            def conv_rw(rw, sfx=sfx):
                return {f"R{sfx}": cols(rw[:, :4 * h]),
                        f"pf{sfx}": rw[:, 4 * h],
                        f"po{sfx}": rw[:, 4 * h + 1],
                        f"pi{sfx}": rw[:, 4 * h + 2]}

            def conv_b(b, sfx=sfx):
                return {f"b{sfx}": cols(b)}
            return [("__multi__", (nin, 4 * h), "f", conv_w),
                    ("__multi__", (h, 4 * h + 3), "f", conv_rw),
                    ("__multi__", (4 * h,), "c", conv_b)]

        if type_name == "gravesLSTM":
            layer = GravesLSTM(n_in=nin, n_out=h, activation=act,
                               gate_activation=gate_act, **common)
            return layer, triplet()
        if type_name == "gravesBidirectionalLSTM":
            # forward (W, RW, b) then backward (W, RW, b), each laid out
            # exactly like GravesLSTM
            # (GravesBidirectionalLSTMParamInitializer.java:98-112)
            layer = GravesBidirectionalLSTM(
                n_in=nin, n_out=h, activation=act,
                gate_activation=gate_act, **common)
            return layer, triplet("f") + triplet("b")

        def conv_rw_plain(rw):
            return {"R": cols(rw)}
        layer = LSTM(n_in=nin, n_out=h, activation=act,
                     gate_activation=gate_act, **common)
        spec = [("__multi__", (nin, 4 * h), "f", lambda w: {"W": cols(w)}),
                ("__multi__", (h, 4 * h), "f", conv_rw_plain),
                ("__multi__", (4 * h,), "c", lambda b: {"b": cols(b)})]
        return layer, spec
    if type_name == "convolution":
        k = _pair(d.get("kernelSize"), (3, 3))
        s = _pair(d.get("stride"), (1, 1))
        p = _pair(d.get("padding"), (0, 0))
        mode = str(d.get("convolutionMode", "Truncate")).lower()
        conv = ConvolutionLayer(n_in=nin, n_out=nout, activation=act,
                                kernel_size=k, stride=s, padding=p,
                                convolution_mode=mode, **common)
        # DL4J conv W: 'c'-order [out, in, kh, kw]
        # (ConvolutionParamInitializer.java:106); ours: [kh, kw, in, out]
        spec = [("W", (nout, nin, k[0], k[1]), "c", (2, 3, 1, 0), None),
                ("b", (nout,), "c", None, None)]
        return conv, spec
    if type_name == "batchNormalization":
        nf = nout or nin
        lock = bool(d.get("lockGammaBeta", False))
        bn = BatchNormalization(
            n_out=nf, decay=float(d.get("decay", 0.9)),
            eps=float(d.get("eps", 1e-5)), lock_gamma_beta=lock,
            gamma_init=float(d.get("gamma", 1.0)),
            beta_init=float(d.get("beta", 0.0)), activation=act, **common)
        # Java layout (BatchNormalizationParamInitializer.java:61-84):
        # [gamma, beta] (omitted when lockGammaBeta) then the running
        # mean/var — trainable here too vs functional STATE on our side
        spec = ([] if lock else
                [("gamma", (nf,), "c", None, None),
                 ("beta", (nf,), "c", None, None)])
        spec += [("__state__", "mean", (nf,), "c"),
                 ("__state__", "var", (nf,), "c")]
        return bn, spec
    if type_name == "subsampling":
        pt = d.get("poolingType", "MAX")
        if isinstance(pt, dict):
            pt = next(iter(pt))
        return SubsamplingLayer(
            pooling_type=str(pt).lower(),
            kernel_size=_pair(d.get("kernelSize"), (2, 2)),
            stride=_pair(d.get("stride"), (2, 2)),
            padding=_pair(d.get("padding"), (0, 0)),
            convolution_mode=str(d.get("convolutionMode",
                                       "Truncate")).lower()), []
    raise ValueError(
        f"unsupported DL4J layer type {type_name!r} (supported: dense, "
        f"output, rnnoutput, loss, embedding, activation, dropout, "
        f"convolution, subsampling, gravesLSTM, LSTM, "
        f"gravesBidirectionalLSTM, batchNormalization)")


def _derive_input_type(layers, preprocs: Dict[str, Any], first_conf):
    """InputType for the rebuilt net. A feedForwardToCnn preprocessor at
    index 0 means the Java net took flattened images
    (FeedForwardToCnnPreProcessor.java fields inputHeight/inputWidth/
    numChannels); a leading conv/subsampling layer means CNN input; else
    plain feed-forward of the first layer's nIn."""
    from ..nn.inputs import InputType
    p0 = preprocs.get("0")
    if p0 and "feedForwardToCnn" in p0:
        f = p0["feedForwardToCnn"]
        return InputType.convolutional_flat(
            int(f.get("inputHeight", f.get("height"))),
            int(f.get("inputWidth", f.get("width"))),
            int(f.get("numChannels", f.get("channels", 1))))
    first = layers[0]
    if type(first).__name__ in ("GravesLSTM", "LSTM",
                                "GravesBidirectionalLSTM"):
        # char-RNN-style net: [B,T,nIn] features, T free (DL4J configs
        # don't pin the sequence length either)
        return InputType.recurrent(first.n_in)
    if type(first).__name__ in ("ConvolutionLayer", "SubsamplingLayer"):
        raise ValueError(
            "DL4J zip with direct CNN input: image height/width are not "
            "recoverable from the Java config alone — pass input_type= to "
            "import_dl4j_zip")
    nin = getattr(first, "n_in", None)
    if not nin:
        raise ValueError("cannot derive input size from the first layer")
    return InputType.feed_forward(nin)


def is_dl4j_zip(path: str) -> bool:
    """True for a reference-format model zip (configuration.json +
    coefficients.bin, no manifest of ours)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
    return (CONFIG_ENTRY in names and PARAMS_ENTRY in names
            and "manifest.json" not in names)


def import_dl4j_zip(path: str, *, input_type=None, load_updater: bool = True,
                    dtype: str = "float32", device: DeviceLike = None):
    """Restore a Java DL4J MultiLayerNetwork zip into the port's
    ``MultiLayerNetwork`` on ``device`` (the CUDA card unless the caller
    names another).

    Returns a net whose params are the zip's coefficients (exactly — the
    'f'-order dense views and 'c'-order conv kernels are transposed into
    the port's layouts), ready to predict. The updater state is imported
    for Nesterovs/SGD (RegressionTest080.java's cases); other rules fall
    back to a fresh optimizer state with a warning in the returned net's
    ``import_notes``."""
    from ..nn.conf.config import NeuralNetConfiguration
    from ..nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path) as z:
        conf_json = json.loads(z.read(CONFIG_ENTRY).decode())
        coeff = z.read(PARAMS_ENTRY)
        upd = (z.read(UPDATER_ENTRY)
               if load_updater and UPDATER_ENTRY in z.namelist() else None)

    confs = conf_json.get("confs")
    if confs is None:
        raise ValueError(f"{path}: no 'confs' — not a MultiLayerConfiguration "
                         "JSON (ComputationGraph import is not supported yet)")
    layers, specs, layer_ds = [], [], []
    first_layer_d = None
    for c in confs:
        wrapper = c.get("layer", {})
        if len(wrapper) != 1:
            raise ValueError(f"malformed layer wrapper: {list(wrapper)}")
        (tname, d), = wrapper.items()
        if first_layer_d is None:
            first_layer_d = d
        layer, spec = _convert_layer(tname, d)
        layers.append(layer)
        specs.append(spec)
        layer_ds.append(d)

    preprocs = conf_json.get("inputPreProcessors") or {}
    notes: List[str] = []

    # DL4J permits PER-LAYER updaters/learning rates; this runtime builds
    # ONE network updater from LAYER 0's config (first_layer_d below).
    # Compare every layer that expresses an updater preference against
    # layer 0's signature — including the case where layer 0 itself
    # carries no updater keys (it then contributes the import defaults) —
    # and say so instead of silently training later layers with the wrong
    # optimizer. Layers with NO updater-relevant keys (subsampling,
    # dropout — nothing to optimize) are skipped: they express no
    # preference to disagree with.
    base_sig = _updater_signature(layer_ds[0]) if layer_ds else ()
    diff = [i for i, d in enumerate(layer_ds[1:], start=1)
            if ("updater" in d or "learningRate" in d)
            and _updater_signature(d) != base_sig]
    if diff:
        notes.append(
            f"heterogeneous per-layer updater configs: layer(s) {diff} "
            f"differ from layer 0 ({dict(base_sig)}); the import uses "
            "layer 0's updater for the WHOLE network — the listed layers "
            "will train with different hyperparameters than the Java net "
            "used")
    for k, p in preprocs.items():
        if "cnnToFeedForward" in p and int(k) < len(specs) and specs[int(k)]:
            f = p["cnnToFeedForward"]
            hh = int(f.get("inputHeight", f.get("height")))
            ww = int(f.get("inputWidth", f.get("width")))
            cc = int(f.get("numChannels", f.get("channels", 1)))
            # The Java preprocessor flattens NCHW (c,h,w); the port
            # flattens NHWC (h,w,c) — re-index the following dense W's
            # input rows so the SAME feature feeds the same weight
            perm = (np.arange(hh * ww * cc).reshape(cc, hh, ww)
                    .transpose(1, 2, 0).ravel())
            entry = specs[int(k)][0]
            if len(entry) == 5 and entry[0] == "W":
                pname, shape, order, transpose, _ = entry
                specs[int(k)][0] = (pname, shape, order, transpose, perm)
            else:
                notes.append(
                    f"cnnToFeedForward before layer {k}: flatten-order "
                    "re-indexing is only implemented for dense-family "
                    "weights — inputs to this layer keep the Java c,h,w "
                    "feature order")
        if "feedForwardToCnn" in p and k == "0":
            cc = int(p["feedForwardToCnn"].get("numChannels", 1))
            if cc > 1:
                notes.append(
                    "input is flattened images with >1 channel: the Java "
                    "net expects c,h,w flattening, this runtime h,w,c — "
                    "permute your input features accordingly")

    itype = input_type or _derive_input_type(layers, preprocs, confs[0])
    seed = int(confs[0].get("seed", 123) or 123)
    updater = _updater_from_java(first_layer_d or {})
    conf = (NeuralNetConfiguration(seed=seed, updater=updater, dtype=dtype)
            .list(*layers).set_input_type(itype).build())
    net = MultiLayerNetwork(conf, device=device).init()

    flat = read_nd4j_array(coeff).astype(np.float32).ravel()
    _assign_flat(net, specs, flat, what=PARAMS_ENTRY)
    net.opt_state = net.updater.init(net.param_dicts())
    net.import_notes = notes
    if upd is not None:
        uflat = read_nd4j_array(upd).astype(np.float32).ravel()
        if type(updater).__name__ in ("Nesterovs", "Sgd", "NoOp"):
            try:
                # Nesterovs state is one momentum buffer with the params'
                # exact flat layout (BaseMultiLayerUpdater state view)
                _assign_updater_state(net, specs, uflat)
            except ValueError as e:
                net.import_notes.append(f"updater state not imported: {e}")
        else:
            net.import_notes.append(
                f"updater state for {type(updater).__name__} uses a "
                "Java-side packing we don't map; starting from a fresh "
                "optimizer state")
    return net


def _split_blocks(specs, flat: np.ndarray, *, what: str
                  ) -> List[Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]]:
    """Walk the per-layer spec over the flat Java buffer, returning one
    (param_blocks, state_blocks) pair of {name: array} dicts per layer.
    Spec entries are either the single-param 5-tuple
    (pname, java_shape, order, transpose, row_perm),
    the multi-param form ("__multi__", java_shape, order, fn) where
    ``fn(block)`` maps ONE Java view onto several of our params (the LSTM
    recurrent matrix carries R plus the three peephole columns), or the
    state form ("__state__", sname, java_shape, order) for buffers that
    are DL4J "params" but functional STATE here (BatchNormalization's
    running mean/var). Returns (param_blocks, state_blocks) per layer."""
    out, off = [], 0
    for spec in specs:
        layer: Dict[str, np.ndarray] = {}
        lstate: Dict[str, np.ndarray] = {}
        for entry in spec:
            if entry[0] == "__state__":
                _, sname, shape, order = entry
            else:
                sname, shape, order = None, entry[1], entry[2]
            n = int(np.prod(shape))
            if off + n > flat.size:
                raise ValueError(f"{what}: ran out of data at "
                                 f"{sname or entry[0]} (need {n} at offset "
                                 f"{off}, have {flat.size})")
            block = flat[off:off + n].reshape(shape, order=order)
            off += n
            if sname is not None:
                lstate[sname] = np.ascontiguousarray(block)
            elif entry[0] == "__multi__":
                for pname, arr in entry[3](block).items():
                    layer[pname] = np.ascontiguousarray(arr)
            else:
                pname, _, _, transpose, row_perm = entry
                if transpose:
                    block = block.transpose(transpose)
                if row_perm is not None:
                    block = block[row_perm]
                layer[pname] = np.ascontiguousarray(block)
        out.append((layer, lstate))
    if off != flat.size:
        raise ValueError(f"{what}: {flat.size - off} trailing values — "
                         "layer/param mapping mismatch")
    return out


@torch.no_grad()
def _write(target: Dict[str, torch.Tensor], blocks: Dict[str, np.ndarray],
           kind: str, what: str) -> None:
    """Copy each block into the tensor of its name, cast to that tensor's
    dtype on its device; every name and shape is checked first."""
    for name, block in blocks.items():
        if name not in target:
            raise ValueError(f"{what}: our layer has no {kind} {name}")
        if tuple(block.shape) != tuple(target[name].shape):
            raise ValueError(f"{what}: {name} shape {block.shape} != "
                             f"{tuple(target[name].shape)}")
    for name, block in blocks.items():
        tgt = target[name]
        tgt.copy_(torch.as_tensor(block).to(tgt.device, tgt.dtype))


def _assign_flat(net, specs, flat: np.ndarray, *, what: str) -> None:
    """Write the Java buffers over the freshly initialized network's
    parameters and layer state, shape-checked."""
    blocks = _split_blocks(specs, flat, what=what)
    params, states = net.param_dicts(), net.state_dicts()
    for i, (pblocks, sblocks) in enumerate(blocks):
        _write(params[i], pblocks, "param", what)
        _write(states[i], sblocks, "state buffer", what)


def _assign_updater_state(net, specs, uflat: np.ndarray) -> None:
    """Map the Java flat updater-state view (same per-layer, per-param
    layout as coefficients.bin) onto the port's named updater tree
    ``{layer: {param: {state: tensor}}}`` by parameter name — valid for
    single-buffer-per-param rules (Nesterovs momentum ``v``). A rule with
    no buffer (Sgd, NoOp) or a layout that does not pair each block with
    one buffer of its shape raises, and nothing is written."""
    writes = []
    for i, (blocks, _sblocks) in enumerate(
            _split_blocks(specs, uflat, what=UPDATER_ENTRY)):
        layer_state = net.opt_state[i]
        buffers = {p: [t for t in s.values() if t.numel() > 0]
                   for p, s in layer_state.items()}
        held = {p for p, b in buffers.items() if b}
        if held != set(blocks) or any(
                len(buffers[p]) != 1
                or tuple(buffers[p][0].shape) != tuple(blocks[p].shape)
                for p in held):
            raise ValueError("optimizer state tree does not mirror the "
                             "param layout one-to-one")
        writes += [(buffers[p][0], blocks[p]) for p in held]
    with torch.no_grad():
        for t, block in writes:
            t.copy_(torch.as_tensor(block).to(t.device, t.dtype))
