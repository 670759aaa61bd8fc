"""Keras HDF5 model import into the port.

Counterpart of ``deeplearning4j_tpu/keras_import/importer.py``. Reference:
deeplearning4j-modelimport — KerasModelImport.java:48-231 (entry
overloads), KerasModel.java:418 (config translation), :510-523 (weight
copy), per-layer translators layers/Keras* (name registry
KerasLayer.java:48-70), Hdf5Archive.java:22-35 (native HDF5 read — h5py
plays the role of the JavaCPP hdf5 binding).

Supports the Keras-1.x-era surface the reference covers (the full
KerasLayer.java:53-70 registry): Sequential and functional Model configs with
Dense, Conv2D(Convolution2D), Conv1D(Convolution1D), MaxPooling1D/2D,
AveragePooling1D/2D, Flatten, Dropout, Activation, BatchNormalization, LSTM,
Embedding, ZeroPadding1D/2D, Merge/Add/Concatenate, GlobalAveragePooling1D/2D,
GlobalMaxPooling1D/2D, TimeDistributed(Dense).
Both 'th' (channels-first) and 'tf' dim orderings; the runtime layout is
NHWC, so 'th' kernels are transposed at import (the analogue of the
reference's TensorFlowCnnToFeedForwardPreProcessor).

The ``.h5`` read (``_read_h5``: the model configuration, the training
loss and ``{layer: [arrays]}``) is apart from the build (``_build``: those
three into a network on ``device``), so a configuration and weights that
come from elsewhere go through the same translation. ``h5py`` is imported
only where a file is opened. The weights are written into the network's
own parameters and layer state, cast to its dtype on its device, and the
updater state is made afresh after the copy.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..nn.conf.config import NeuralNetConfiguration
from ..nn.inputs import InputType
from ..nn.layers import (ActivationLayer, BatchNormalization,
                         Convolution1DLayer, ConvolutionLayer, DenseLayer,
                         DropoutLayer, EmbeddingLayer, GlobalPoolingLayer,
                         LSTM, OutputLayer, Subsampling1DLayer,
                         SubsamplingLayer, ZeroPadding1DLayer,
                         ZeroPaddingLayer)
from ..nn.multilayer import MultiLayerNetwork

_ACT_MAP = {
    "linear": "identity", "relu": "relu", "sigmoid": "sigmoid",
    "softmax": "softmax", "tanh": "tanh", "softplus": "softplus",
    "softsign": "softsign", "hard_sigmoid": "hardsigmoid", "elu": "elu",
    "selu": "selu",
}

_LOSS_MAP = {
    "categorical_crossentropy": "mcxent", "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mean_absolute_error", "mae": "mean_absolute_error",
    "kullback_leibler_divergence": "kl_divergence", "poisson": "poisson",
    "cosine_proximity": "cosine_proximity", "hinge": "hinge",
    "squared_hinge": "squared_hinge",
    "sparse_categorical_crossentropy": "sparse_mcxent",
}


def _keras_act(cfg, default="identity"):
    a = cfg.get("activation", default) or default
    if a not in _ACT_MAP:
        raise ValueError(f"Unsupported Keras activation {a!r}")
    return _ACT_MAP[a]


def _normalize_loss_entry(loss):
    """One training-config loss entry -> canonical keras snake_case name.
    Handles plain strings and serialized loss OBJECTS ({'class_name': ...,
    'config': {'name': 'mean_squared_error', ...}}) that keras writes when
    the model was compiled with e.g. keras.losses.MeanSquaredError()."""
    if loss is None or isinstance(loss, str):
        return loss
    if isinstance(loss, dict) and "class_name" in loss:
        name = (loss.get("config") or {}).get("name")
        if name:
            return name
        import re
        return re.sub(r"(?<!^)(?=[A-Z])", "_", loss["class_name"]).lower()
    return loss


def _keras_loss(loss: Optional[str], enforce: bool = False) -> str:
    """Map a Keras loss name; unknown -> mcxent fallback (raise when
    enforce_training_config, reference KerasModel enforceTrainingConfig)."""
    loss = _normalize_loss_entry(loss)
    if loss is None:
        return "mcxent"
    if isinstance(loss, str) and loss in _LOSS_MAP:
        return _LOSS_MAP[loss]
    if enforce:
        raise ValueError(f"Unsupported Keras loss {loss!r} "
                         f"(enforce_training_config=True)")
    return "mcxent"


class KerasLayerTranslator:
    """Translate one Keras layer config dict -> the port's layer conf (or None
    for structural layers like Flatten/InputLayer, which the InputType
    system absorbs)."""

    def __init__(self, dim_ordering: str = "tf", enforce: bool = False):
        self.dim_ordering = dim_ordering
        self.enforce = enforce

    def translate(self, klass: str, cfg: Dict[str, Any], is_output: bool,
                  loss: Optional[str]):
        if klass in ("InputLayer", "Flatten", "Reshape"):
            return None
        if klass == "Dense":
            n_out = cfg.get("output_dim") or cfg.get("units")
            act = _keras_act(cfg)
            if is_output:
                return OutputLayer(n_out=int(n_out), activation=act,
                                   loss=_keras_loss(loss, self.enforce))
            return DenseLayer(n_out=int(n_out), activation=act)
        if klass in ("Convolution2D", "Conv2D"):
            n_out = cfg.get("nb_filter") or cfg.get("filters")
            if "nb_row" in cfg:
                k = (cfg["nb_row"], cfg["nb_col"])
            else:
                k = tuple(cfg["kernel_size"])
            stride = tuple(cfg.get("subsample") or cfg.get("strides") or (1, 1))
            border = cfg.get("border_mode") or cfg.get("padding") or "valid"
            mode = "same" if border == "same" else "truncate"
            return ConvolutionLayer(n_out=int(n_out), kernel_size=k, stride=stride,
                                    convolution_mode=mode, activation=_keras_act(cfg))
        if klass in ("MaxPooling2D", "AveragePooling2D"):
            pt = "max" if klass.startswith("Max") else "avg"
            k = tuple(cfg.get("pool_size") or (2, 2))
            s = tuple(cfg.get("strides") or k)
            border = cfg.get("border_mode") or cfg.get("padding") or "valid"
            return SubsamplingLayer(pooling_type=pt, kernel_size=k, stride=s,
                                    convolution_mode="same" if border == "same"
                                    else "truncate",
                                    avg_pool_include_pad_in_divisor=False)
        if klass in ("GlobalAveragePooling2D", "GlobalMaxPooling2D",
                     "GlobalAveragePooling1D", "GlobalMaxPooling1D"):
            return GlobalPoolingLayer(pooling_type="avg" if "Average" in klass
                                      else "max")
        if klass in ("Convolution1D", "Conv1D"):
            n_out = cfg.get("nb_filter") or cfg.get("filters")
            k = cfg.get("filter_length") or cfg.get("kernel_size")
            if isinstance(k, (list, tuple)):
                k = k[0]
            s = cfg.get("subsample_length") or cfg.get("strides") or 1
            if isinstance(s, (list, tuple)):
                s = s[0]
            border = cfg.get("border_mode") or cfg.get("padding") or "valid"
            if border == "causal":
                raise ValueError("Conv1D padding='causal' is not supported "
                                 "(reference Keras-1 registry has valid/same "
                                 "only, KerasConvolution translator)")
            return Convolution1DLayer(
                n_out=int(n_out), kernel_size=int(k), stride=int(s),
                convolution_mode="same" if border == "same" else "truncate",
                activation=_keras_act(cfg))
        if klass in ("MaxPooling1D", "AveragePooling1D"):
            k = cfg.get("pool_length") or cfg.get("pool_size") or 2
            if isinstance(k, (list, tuple)):
                k = k[0]
            s = cfg.get("stride") or cfg.get("strides") or k
            if isinstance(s, (list, tuple)):
                s = s[0]
            border = cfg.get("border_mode") or cfg.get("padding") or "valid"
            return Subsampling1DLayer(
                pooling_type="max" if klass.startswith("Max") else "avg",
                kernel_size=int(k), stride=int(s),
                convolution_mode="same" if border == "same" else "truncate",
                avg_pool_include_pad_in_divisor=False)
        if klass == "ZeroPadding1D":
            pad = cfg.get("padding", 1)
            if isinstance(pad, (list, tuple)):
                return ZeroPadding1DLayer(padding=tuple(int(v) for v in pad))
            return ZeroPadding1DLayer(padding=int(pad))
        if klass == "TimeDistributed":
            # reference KerasLayer.java:69 LAYER_CLASS_NAME_TIME_DISTRIBUTED_
            # DENSE: only the Dense wrapper is in the registry. Our DenseLayer
            # is natively time-distributed over [B,T,F] (broadcast matmul),
            # so the wrapper dissolves to a DenseLayer.
            inner = cfg.get("layer") or {}
            if inner.get("class_name") != "Dense":
                raise ValueError(
                    f"TimeDistributed({inner.get('class_name')!r}) is not "
                    f"supported (reference covers TimeDistributed(Dense) only)")
            icfg = inner.get("config", {})
            n_out = icfg.get("output_dim") or icfg.get("units")
            if is_output:
                from ..nn.layers import RnnOutputLayer
                return RnnOutputLayer(n_out=int(n_out),
                                      activation=_keras_act(icfg),
                                      loss=_keras_loss(loss, self.enforce))
            return DenseLayer(n_out=int(n_out), activation=_keras_act(icfg))
        if klass == "Dropout":
            p = cfg.get("p") or cfg.get("rate") or 0.5
            return DropoutLayer(dropout=1.0 - float(p))  # keras p = drop prob
        if klass == "Activation":
            if is_output:
                # final standalone Activation (e.g. Dense(linear) + Activation
                # ('softmax')) becomes the scoring layer, so multi-layer heads
                # import as a proper output layer instead of mis-assigning the
                # loss to the preceding Dense.
                from ..nn.layers import LossLayer
                return LossLayer(activation=_keras_act(cfg),
                                 loss=_keras_loss(loss, self.enforce))
            return ActivationLayer(activation=_keras_act(cfg))
        if klass == "BatchNormalization":
            return BatchNormalization(eps=float(cfg.get("epsilon", 1e-5)),
                                      decay=float(cfg.get("momentum", 0.9)))
        if klass == "ZeroPadding2D":
            pad = cfg.get("padding") or (1, 1)
            if isinstance(pad, (list, tuple)) and len(pad) == 2 and \
                    not isinstance(pad[0], (list, tuple)):
                return ZeroPaddingLayer(padding=tuple(pad))
            (t, b), (l, r) = pad
            return ZeroPaddingLayer(padding=(t, b, l, r))
        if klass == "LSTM":
            n_out = cfg.get("output_dim") or cfg.get("units")
            return LSTM(n_out=int(n_out), activation=_keras_act(cfg, "tanh"),
                        gate_activation=_ACT_MAP.get(
                            cfg.get("inner_activation") or
                            cfg.get("recurrent_activation") or "sigmoid",
                            "sigmoid"))
        if klass == "Embedding":
            return EmbeddingLayer(n_in=int(cfg["input_dim"]),
                                  n_out=int(cfg.get("output_dim") or cfg["units"]))
        raise ValueError(f"Unsupported Keras layer class {klass!r} "
                         f"(reference registry KerasLayer.java:48-70)")


def _input_type_from(cfg: Dict[str, Any], dim_ordering: str):
    shape = cfg.get("batch_input_shape") or cfg.get("batch_shape")
    if shape is None:
        return None
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        return InputType.feed_forward(dims[0])
    if len(dims) == 2:
        return InputType.recurrent(dims[1], dims[0])
    if len(dims) == 3:
        if dim_ordering == "th":
            c, h, w = dims
        else:
            h, w, c = dims
        return InputType.convolutional(h, w, c)
    return None


def _collect_weights(f, layer_names):
    """h5 'model_weights'/<layer>/<param datasets> -> {layer: [arrays]}"""
    g = f["model_weights"] if "model_weights" in f else f
    out = {}
    for name in layer_names:
        if name not in g:
            continue
        lg = g[name]
        wn = [n.decode() if isinstance(n, bytes) else n
              for n in lg.attrs.get("weight_names", [])]
        if len(wn):
            arrays = [np.array(lg[n]) for n in wn]
        else:
            arrays = [np.array(lg[k]) for k in sorted(lg.keys())]
        if arrays:
            out[name] = arrays
    return out


def _convert_lstm_weights(arrays, H):
    """Keras-1 LSTM: 12 arrays (W,U,b per gate, order i,c,f,o in keras1 /
    i,f,c,o in some versions) or Keras-2 fused (W[in,4H], U[H,4H], b[4H],
    gate order i,f,c,o). Our packed order is [i,f,o,g]."""
    if len(arrays) == 3:
        W, U, b = arrays
        def reorder(m):
            i, f, c, o = np.split(m, 4, axis=-1)
            return np.concatenate([i, f, o, c], axis=-1)
        return {"W": reorder(W), "R": reorder(U), "b": reorder(b)}
    if len(arrays) == 12:
        # keras1 order: W_i,U_i,b_i, W_c,U_c,b_c, W_f,U_f,b_f, W_o,U_o,b_o
        Wi, Ui, bi, Wc, Uc, bc, Wf, Uf, bf, Wo, Uo, bo = arrays
        return {"W": np.concatenate([Wi, Wf, Wo, Wc], axis=-1),
                "R": np.concatenate([Ui, Uf, Uo, Uc], axis=-1),
                "b": np.concatenate([bi, bf, bo, bc], axis=-1)}
    raise ValueError(f"Unexpected LSTM weight count {len(arrays)}")


def _layer_names(model_cfg) -> List[str]:
    """Every layer name of a Sequential or functional configuration."""
    layer_cfgs = model_cfg.get("config", [])
    if isinstance(layer_cfgs, dict):
        layer_cfgs = layer_cfgs.get("layers", [])
    return [n for n in ((lc.get("config") or {}).get("name") or lc.get("name")
                        for lc in layer_cfgs) if n]


def _read_h5(path: str):
    """Open a Keras ``.h5`` file: (model configuration, training loss,
    ``{layer: [arrays]}`` in each layer's ``weight_names`` order)."""
    import h5py
    with h5py.File(path, "r") as f:
        model_cfg, loss = _read_model_config(f, path)
        weights = _collect_weights(f, _layer_names(model_cfg))
    return model_cfg, loss, weights


def _build(model_cfg, loss, weights, *, enforce_training_config=False,
           device: DeviceLike = None, path: str = "<model_config>"):
    """A Sequential configuration becomes a ``MultiLayerNetwork``, any
    other a ``ComputationGraph``, on ``device``, with ``weights`` copied
    in."""
    if model_cfg.get("class_name") == "Sequential":
        return _build_sequential(model_cfg, loss, weights,
                                 enforce_training_config, device)
    return _build_functional(model_cfg, loss, weights,
                             enforce_training_config, device, path)


def import_keras_sequential_model_and_weights(
        path: str, *, enforce_training_config=False,
        device: DeviceLike = None) -> MultiLayerNetwork:
    """Reference KerasModelImport.importKerasSequentialModelAndWeights."""
    model_cfg, loss, weights = _read_h5(path)
    if model_cfg.get("class_name") != "Sequential":
        raise ValueError("Use import_keras_model_and_weights for functional models")
    return _build_sequential(model_cfg, loss, weights,
                             enforce_training_config, device)


def _build_sequential(model_cfg, loss, weights, enforce_training_config,
                      device: DeviceLike) -> MultiLayerNetwork:
    if isinstance(loss, dict) and "class_name" not in loss:
        loss = next(iter(loss.values()), None)   # single-output: any entry
    elif isinstance(loss, (list, tuple)):
        loss = loss[0] if loss else None
    layer_cfgs = model_cfg["config"]
    if isinstance(layer_cfgs, dict):
        layer_cfgs = layer_cfgs["layers"]

    dim_ordering = _detect_dim_ordering(layer_cfgs)
    tr = KerasLayerTranslator(dim_ordering, enforce=enforce_training_config)
    confs, keras_names, keras_classes = [], [], []
    itype = None
    for i, lc in enumerate(layer_cfgs):
        cfg = lc.get("config", {})
        if itype is None:
            it = _input_type_from(cfg, dim_ordering)
            if it is not None:
                itype = it
        is_out = i == len(layer_cfgs) - 1
        conf = tr.translate(lc["class_name"], cfg, is_out, loss)
        if conf is not None:
            confs.append(conf)
            keras_names.append(cfg.get("name") or lc.get("name"))
            keras_classes.append(lc["class_name"])
    b = NeuralNetConfiguration(seed=12345, activation="identity",
                               weight_init="xavier").list(*confs)
    if itype is not None:
        b = b.set_input_type(itype)
    net = MultiLayerNetwork(b.build(), device=device).init()
    _copy_weights_mln(net, keras_names, keras_classes, weights, dim_ordering)
    return net


@torch.no_grad()
def _assign_layer_arrays(layer, arrays, pdict, sdict, dim_ordering):
    """Write one Keras layer's weight arrays into a layer's parameters and
    state, in place (reference KerasModel.java:510-523
    copyWeightsToModel). Shared by the Sequential (MLN) and functional
    (ComputationGraph) import paths."""
    def put(target, key, src):
        target[key].copy_(np_cast(src, target[key]))

    if isinstance(layer, (ConvolutionLayer, Convolution1DLayer)):
        W = arrays[0]
        if W.ndim == 4 and dim_ordering == "th":
            W = W.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        # keras Conv1D kernels are (k, in, out) = the port's WIO already
        put(pdict, "W", W)
        if len(arrays) > 1:
            put(pdict, "b", arrays[1])
    elif isinstance(layer, LSTM):
        conv = _convert_lstm_weights(arrays, layer.n_out)
        for k, v in conv.items():
            put(pdict, k, v)
    elif isinstance(layer, BatchNormalization):
        # keras order: gamma, beta, running_mean, running_var
        put(pdict, "gamma", arrays[0])
        put(pdict, "beta", arrays[1])
        if len(arrays) >= 4:
            put(sdict, "mean", arrays[2])
            put(sdict, "var", arrays[3])
    elif isinstance(layer, (DenseLayer, EmbeddingLayer)):
        put(pdict, "W", arrays[0])
        if len(arrays) > 1 and "b" in pdict:
            put(pdict, "b", arrays[1])


def _copy_weights_mln(net, keras_names, keras_classes, weights, dim_ordering):
    params, state = net.param_dicts(), net.state_dicts()
    for li, (kname, kclass) in enumerate(zip(keras_names, keras_classes)):
        if kname not in weights:
            continue
        _assign_layer_arrays(net.layers[li], weights[kname], params[li],
                             state[li], dim_ordering)
    net.opt_state = net.updater.init(net.param_dicts())


def np_cast(src, like: torch.Tensor) -> torch.Tensor:
    """``src`` as a tensor of ``like``'s dtype on ``like``'s device, after
    the reference's shape check."""
    src = np.asarray(src)
    if src.shape != tuple(like.shape):
        raise ValueError(f"Weight shape mismatch: keras {src.shape} vs "
                         f"model {tuple(like.shape)}")
    return torch.as_tensor(src).to(like.device, like.dtype)


# --------------------------------------------------------------- functional
def _inbound_names(node) -> List[str]:
    """Extract input layer names from one inbound node, covering both the
    legacy Keras-1/2 format ([["name", node_idx, tensor_idx, {...}], ...])
    and the Keras-3 format ({"args": [{"class_name": "__keras_tensor__",
    "config": {"keras_history": ["name", 0, 0]}}, ...], "kwargs": ...})."""
    names: List[str] = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("class_name") == "__keras_tensor__":
                names.append(o["config"]["keras_history"][0])
            elif "args" in o:
                walk(o["args"])
        elif isinstance(o, (list, tuple)):
            if (len(o) >= 3 and isinstance(o[0], str)
                    and isinstance(o[1], int) and isinstance(o[2], int)):
                names.append(o[0])
            else:
                for v in o:
                    walk(v)

    walk(node)
    return names


def _io_layer_names(entry) -> List[str]:
    """config['input_layers'] / ['output_layers']: either [name, 0, 0] for a
    single tensor or [[name, 0, 0], ...] for several."""
    if not entry:
        return []
    if isinstance(entry[0], str):
        return [entry[0]]
    return [e[0] for e in entry]


def _loss_for_output(loss, out_name: str, out_index: int):
    """Keras training_config loss may be a single loss (str or serialized
    object — applies to all outputs), a dict keyed by output layer name, or a
    positional list."""
    if loss is None or isinstance(loss, str):
        return loss
    if isinstance(loss, dict):
        if "class_name" in loss:  # one serialized loss object for all outputs
            return loss
        return loss.get(out_name)
    if isinstance(loss, (list, tuple)) and out_index < len(loss):
        return loss[out_index]
    return None


def _detect_dim_ordering(layer_cfgs) -> str:
    """'tf' (channels-last) unless a Keras-1 'dim_ordering' key says 'th'.
    Keras-1 'th' files store conv kernels OIHW (transposed at weight copy);
    Keras>=2 'channels_first' models store kernels HWIO regardless, but their
    whole dataflow is NCHW — unsupported against the NHWC runtime, so gate
    clearly instead of importing garbage."""
    for lc in layer_cfgs:
        c = lc.get("config", {})
        if c.get("data_format") == "channels_first":
            raise ValueError(
                "channels_first Keras models are not supported; rebuild the "
                "model with data_format='channels_last' (runtime layout is "
                "NHWC)")
        if "dim_ordering" in c:
            return c["dim_ordering"]
    return "tf"


def _read_model_config(f, path):
    raw = f.attrs.get("model_config")
    if raw is None:
        raise ValueError(f"{path} has no model_config attribute")
    model_cfg = json.loads(raw if isinstance(raw, str) else raw.decode())
    training_cfg = f.attrs.get("training_config")
    loss = None
    if training_cfg is not None:
        tc = json.loads(training_cfg if isinstance(training_cfg, str)
                        else training_cfg.decode())
        loss = tc.get("loss")
    return model_cfg, loss


def import_keras_model_and_weights(path: str, *, enforce_training_config=False,
                                   device: DeviceLike = None):
    """Functional Keras Model -> ComputationGraph with weights copied
    (reference KerasModel.java:418 getComputationGraphConfiguration +
    :510-523 getComputationGraph/copyWeightsToModel)."""
    model_cfg, loss, weights = _read_h5(path)
    return _build_functional(model_cfg, loss, weights,
                             enforce_training_config, device, path)


def _build_functional(model_cfg, loss, weights, enforce_training_config,
                      device: DeviceLike, path: str):
    """Layers become LayerVertex entries in the Keras topological order;
    merge layers become Merge/ElementWise vertices; structural layers
    (InputLayer/Flatten/Reshape) are dissolved, their consumers rewired to
    the producer — the InputType machinery auto-inserts the CNN->FF
    preprocessor the Flatten stood for."""
    from ..nn.graph.graph import ComputationGraph
    from ..nn.graph.vertices import (ElementWiseVertex, LastTimeStepVertex,
                                     MergeVertex)

    if model_cfg.get("class_name") not in ("Model", "Functional"):
        raise ValueError(f"{path} is not a functional Keras model "
                         f"(class {model_cfg.get('class_name')!r})")
    cfg = model_cfg["config"]
    layer_cfgs = cfg["layers"]
    in_names = _io_layer_names(cfg.get("input_layers"))
    out_names = _io_layer_names(cfg.get("output_layers"))

    dim_ordering = _detect_dim_ordering(layer_cfgs)
    tr = KerasLayerTranslator(dim_ordering, enforce=enforce_training_config)

    b = (NeuralNetConfiguration(seed=12345, activation="identity",
                                weight_init="xavier")
         .graph_builder())
    b.add_inputs(*in_names)

    # name -> resolved vertex name (structural layers dissolve to their
    # producer, like the reference's preprocessor-only KerasLayer merge).
    resolved: Dict[str, str] = {n: n for n in in_names}
    input_types: Dict[str, Any] = {}
    keras_name_of: Dict[str, str] = {}   # vertex name -> keras layer name

    _MERGE = {"Concatenate": "concat", "Merge": None, "Add": "add",
              "Average": "average", "Maximum": "max", "Subtract": "subtract",
              "Multiply": "product"}

    for lc in layer_cfgs:
        klass = lc["class_name"]
        c = lc.get("config", {})
        name = c.get("name") or lc.get("name")
        inbound = [n for node in lc.get("inbound_nodes", [])
                   for n in _inbound_names(node)]
        srcs = [resolved[n] for n in inbound]
        if klass == "InputLayer":
            it = _input_type_from(c, dim_ordering)
            if it is not None:
                input_types[name] = it
            resolved[name] = name
            continue
        if klass in ("Flatten", "Reshape"):
            resolved[name] = srcs[0]
            continue
        if klass in _MERGE:
            mode = _MERGE[klass]
            if klass == "Merge":  # keras-1 Merge(mode=...)
                m = c.get("mode", "concat")
                mode = {"sum": "add", "concat": "concat", "mul": "product",
                        "ave": "average", "max": "max"}.get(m)
                if mode is None:
                    raise ValueError(f"Unsupported Merge mode {m!r}")
            if mode == "concat":
                b.add_vertex(name, MergeVertex(), *srcs)
            else:
                b.add_vertex(name, ElementWiseVertex(op=mode), *srcs)
            resolved[name] = name
            keras_name_of[name] = name
            continue
        is_out = name in out_names
        out_loss = _loss_for_output(loss, name, out_names.index(name)) \
            if is_out else None
        conf = tr.translate(klass, c, is_out, out_loss)
        if conf is None:
            resolved[name] = srcs[0]
            continue
        if klass == "LSTM" and not c.get("return_sequences", False):
            # keras LSTM(return_sequences=False) emits [B,H] at the last
            # step; the port's LSTM emits the whole sequence -> append the
            # LastTimeStep vertex (reference rnn/LastTimeStepVertex).
            b.add_layer(name + "__seq", conf, *srcs)
            b.add_vertex(name, LastTimeStepVertex(), name + "__seq")
            keras_name_of[name + "__seq"] = name
            resolved[name] = name
            continue
        b.add_layer(name, conf, *srcs)
        keras_name_of[name] = name
        resolved[name] = name

    b.set_outputs(*[resolved[n] for n in out_names])
    if len(input_types) == len(in_names):
        b.set_input_types(*[input_types[n] for n in in_names])
    graph = ComputationGraph(b.build(), device=device).init()
    _copy_weights_cg(graph, keras_name_of, weights, dim_ordering)
    return graph


def _copy_weights_cg(graph, keras_name_of, weights, dim_ordering):
    params, state = graph.param_dicts(), graph.state_dicts()
    for vname in graph.vertex_names:
        kname = keras_name_of.get(vname)
        if kname is None or kname not in weights:
            continue
        layer = getattr(graph.vertices[vname], "layer", None)
        if layer is None:
            continue
        _assign_layer_arrays(layer, weights[kname], params[vname],
                             state[vname], dim_ordering)
    graph.opt_state = graph.updater.init(graph.param_dicts())


def import_keras_model(path: str, *, enforce_training_config=False,
                       device: DeviceLike = None):
    """Reference KerasModelImport.importKerasModelAndWeights: sniff
    Sequential vs functional."""
    import h5py
    with h5py.File(path, "r") as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise ValueError(f"{path}: no model_config")
        cfg = json.loads(raw if isinstance(raw, str) else raw.decode())
    if cfg.get("class_name") == "Sequential":
        return import_keras_sequential_model_and_weights(
            path, enforce_training_config=enforce_training_config,
            device=device)
    return import_keras_model_and_weights(
        path, enforce_training_config=enforce_training_config, device=device)
