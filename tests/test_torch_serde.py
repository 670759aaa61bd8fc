"""The port's configuration JSON (``nn/conf/serde.py``) against the JAX
package's.

Every class the port registers that the JAX registry also holds goes JAX
``to_json`` -> port ``from_json`` -> port ``to_json`` -> JAX ``from_json``
with a non-default value in every field, and comes back equal; the port's
JSON of the same zoo configuration equals the JAX package's as a dict; a
non-default value of every field round-trips through the port alone (the
counterpart of ``tests/test_serde_completeness.py``); and every class the
JAX registry holds that the port lacks raises naming its ROADMAP item.
Activations and losses are names (strings) in both packages' JSON: each
name either package knows is known to the other."""
import _torch_threads  # noqa: F401
import dataclasses
import importlib
import json
import pkgutil

import pytest

import deeplearning4j_tpu as jpkg
from deeplearning4j_tpu.models import zoo_extra as jzoo
from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import losses as jloss
from deeplearning4j_tpu.nn.conf import serde as jserde
from deeplearning4j_tpu_torch.models import zoo_extra as tzoo
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import losses as tloss
from deeplearning4j_tpu_torch.nn.conf import serde as tserde

for _m in pkgutil.walk_packages(jpkg.__path__, "deeplearning4j_tpu."):
    if _m.name.startswith(("deeplearning4j_tpu.nn.",
                           "deeplearning4j_tpu.optimize.")):
        importlib.import_module(_m.name)
tserde._load_all()

J, T = jserde._REGISTRY, tserde._REGISTRY
SHARED = sorted(set(J) & set(T))
LACKING = sorted(set(J) - set(T))

# values for fields whose default is None (or needs a nested object)
_NESTED = {
    "name": "n1", "activation": "relu", "weight_init": "distribution",
    "distribution": ("NormalDistribution", dict(mean=0.5, std=2.0)),
    "bias_init": 0.25, "l1": 0.01, "l2": 0.02, "dropout": 0.9,
    "updater": ("Adam", dict(learning_rate=0.01, beta1=0.8)),
    "learning_rate": 0.05, "bias_learning_rate": 0.02, "n_in": 7,
    "n_out": 5, "cudnn_algo_mode": "NO_WORKSPACE",
    "schedule": ("StepSchedule", dict(decay_rate=0.5, step_size=10)),
    "gradient_normalization": "clipl2perlayer", "input_type":
        ("InputTypeConvolutional", dict(height=4, width=4, channels=2)),
    "layer_conf": ("DenseLayer", dict(n_in=3, n_out=4, frozen=True)),
    "preprocessor": ("CnnToFeedForwardPreProcessor",
                     dict(height=2, width=2, channels=1)),
}


def _poke(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value + 0.125
    if isinstance(value, (tuple, list)):
        return [_poke(v) for v in value]
    return value


def _nested(reg, name):
    v = _NESTED[name]
    if isinstance(v, tuple):
        cls_name, kw = v
        return _make(reg, cls_name, kw)
    return v


def _make(reg, cls_name, kw):
    cls = reg[cls_name]
    return cls(**kw)


def _jax_fields(cls):
    return [f for f in dataclasses.fields(cls)
            if not f.metadata.get("skip_serde", False)]


def _jax_instance(name):
    """A JAX object of class ``name`` with a non-default value in every
    field (the value the port must carry across)."""
    cls = J[name]
    if name == "MapSchedule":
        return cls(schedule={"0": 0.1, "10": 0.01})
    if name == "MultiLayerConfiguration":
        return cls(layers=[_make(J, "DenseLayer", dict(n_in=8, n_out=3)),
                           _make(J, "OutputLayer", dict(n_out=2))],
                   input_preprocessors={"0": _make(
                       J, "CnnToFeedForwardPreProcessor",
                       dict(height=2, width=2, channels=2))},
                   input_type=_nested(J, "input_type"), seed=7,
                   dtype="bfloat16", backprop_type="tbptt",
                   tbptt_fwd_length=9, tbptt_bwd_length=9, pretrain=True,
                   gradient_normalization="clipl2perlayer",
                   gradient_normalization_threshold=2.5,
                   updater=_nested(J, "updater"),
                   optimization_algorithm="lbfgs",
                   max_num_line_search_iterations=7,
                   gradient_checkpointing=True, compute_dtype="bfloat16")
    if name == "ComputationGraphConfiguration":
        return cls(network_inputs=["in"], network_outputs=["out"],
                   vertex_names=["a", "m", "out"],
                   vertices={"a": _make(J, "LayerVertex", dict(
                                 layer_conf=_make(J, "DenseLayer",
                                                  dict(n_in=5, n_out=4)))),
                             "m": _make(J, "MergeVertex", {}),
                             "out": _make(J, "LayerVertex", dict(
                                 layer_conf=_make(J, "OutputLayer",
                                                  dict(n_in=8, n_out=2))))},
                   vertex_inputs={"a": ["in"], "m": ["a", "a"],
                                  "out": ["m"]},
                   input_types=[_make(J, "InputTypeFeedForward",
                                      dict(size=5))],
                   seed=3, dtype="float64", backprop_type="tbptt",
                   tbptt_fwd_length=6, tbptt_bwd_length=6,
                   gradient_normalization="clipl2perparamtype",
                   gradient_normalization_threshold=0.5,
                   updater=_nested(J, "updater"),
                   optimization_algorithm="conjugate_gradient",
                   max_num_line_search_iterations=2,
                   gradient_checkpointing=True, compute_dtype="bfloat16")
    kw = {}
    for f in _jax_fields(cls):
        if f.name in _NESTED and (f.default is None or
                                  f.default is dataclasses.MISSING
                                  or f.name in ("layer_conf",)):
            kw[f.name] = _nested(J, f.name)
        elif f.default is not dataclasses.MISSING:
            kw[f.name] = _poke(f.default)
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore
            kw[f.name] = _poke(f.default_factory())
        else:
            kw[f.name] = 3
    return cls(**kw)


@pytest.mark.parametrize("name", SHARED)
def test_every_shared_class_round_trips_through_both_packages(name):
    jobj = _jax_instance(name)
    jjson = jserde.to_json(jobj)
    tobj = tserde.from_json(jjson)
    assert type(tobj) is T[name]
    tjson = tserde.to_json(tobj)
    assert json.loads(tjson) == json.loads(jjson)
    back = jserde.from_json(tjson)
    assert type(back) is J[name]
    assert jserde.to_dict(back) == jserde.to_dict(jobj)


def test_the_port_writes_the_references_fields_in_its_order():
    for name in SHARED:
        assert list(tserde.field_names(T[name])) == \
            [f.name for f in _jax_fields(J[name])], name


_ZOO = [("googlenet", dict(n_classes=10, height=32, width=32)),
        ("transformer_lm", dict(vocab_size=50, d_model=32, n_heads=2,
                                n_blocks=2, max_length=64)),
        ("transformer_lm", dict(vocab_size=50, d_model=32, n_heads=2,
                                n_blocks=1, max_length=64,
                                token_input=True)),
        ("text_generation_lstm", dict(vocab_size=31, hidden=16))]


@pytest.mark.parametrize("zoo, kw", _ZOO,
                         ids=[f"{z}-{i}" for i, (z, _) in enumerate(_ZOO)])
def test_zoo_configuration_json_equals_the_references(zoo, kw):
    pconf = getattr(tzoo, zoo)(**kw, device="cpu").conf
    jconf = getattr(jzoo, zoo)(**kw).conf
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    assert json.loads(type(pconf).from_json(jconf.to_json()).to_json()) == \
        json.loads(jconf.to_json())


def test_built_cnn_configuration_inserts_the_references_preprocessor():
    from deeplearning4j_tpu import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn import layers as jl
    from deeplearning4j_tpu.nn.inputs import InputType as JIT
    from deeplearning4j_tpu_torch.nn.conf.config import \
        NeuralNetConfiguration as TConf
    from deeplearning4j_tpu_torch.nn import layers as tl
    from deeplearning4j_tpu_torch.nn.inputs import InputType as TIT

    def build(conf, L, it):
        return (conf(seed=7, activation="relu").list(
            L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                               convolution_mode="same"),
            L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
            L.DenseLayer(n_out=16, activation="tanh"),
            L.OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(it.convolutional(8, 8, 2)).build())

    pconf, jconf = build(TConf, tl, TIT), build(JConf, jl, JIT)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    assert type(pconf.preprocessor(2)).__name__ == \
        "CnnToFeedForwardPreProcessor"


def _port_instance(name):
    """The JAX instance carried into the port (each port field then holds
    a non-default value)."""
    return tserde.from_json(jserde.to_json(_jax_instance(name)))


@pytest.mark.parametrize("name", sorted(T))
def test_registered_port_class_round_trips_with_non_defaults(name):
    cls = T[name]
    obj = _port_instance(name)
    back = tserde.from_json(tserde.to_json(obj))
    assert type(back) is cls
    for f in tserde.field_names(cls):
        a, b = getattr(obj, f), getattr(back, f)
        a, b = tserde.to_dict(a), tserde.to_dict(b)
        assert a == b, (name, f, a, b)


# the classes ROADMAP A5's second half took out of ``NOT_PORTED``, which
# left it empty
PORTED_IN_A5_SECOND_HALF = (
    "DropoutLayer", "EmbeddingLayer", "LossLayer", "AutoEncoder",
    "VariationalAutoencoder", "RBM", "Convolution1DLayer",
    "Subsampling1DLayer", "ZeroPadding1DLayer",
    "BernoulliReconstructionDistribution",
    "GaussianReconstructionDistribution",
    "ExponentialReconstructionDistribution",
    "CompositeReconstructionDistribution", "LossFunctionWrapper",
    "BinomialDistribution", "ShiftVertex", "L2Vertex", "StackVertex",
    "UnstackVertex", "SubsetVertex", "PreprocessorVertex",
    "PoolHelperVertex", "LastTimeStepVertex", "DuplicateToTimeSeriesVertex")


@pytest.mark.parametrize("name", PORTED_IN_A5_SECOND_HALF)
def test_a_class_the_port_lacks_raises_naming_its_item(name, monkeypatch):
    """No registered class of the reference is lacking any more; the
    lookup still names the item of a class listed in ``NOT_PORTED`` (each
    former one, taken out of the registry for the check)."""
    assert name in T and name not in tserde.NOT_PORTED
    monkeypatch.delitem(tserde._REGISTRY, name)
    monkeypatch.setitem(tserde.NOT_PORTED, name, "A5")
    monkeypatch.setattr(tserde, "_load_all", lambda: None)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A5"):
        tserde.from_dict({"@class": name})


@pytest.mark.parametrize("name", PORTED_IN_A5_SECOND_HALF)
def test_a_class_ported_in_a5_second_half_round_trips_the_jax_json(name):
    assert name in T and name not in tserde.NOT_PORTED
    payload = jserde.to_json(_jax_instance(name))
    obj = tserde.from_json(payload)
    assert type(obj) is T[name]
    assert json.loads(tserde.to_json(obj)) == json.loads(payload)
    back = jserde.from_json(tserde.to_json(obj))
    assert json.loads(jserde.to_json(back)) == json.loads(payload)


# the classes ROADMAP A5's first half took out of ``NOT_PORTED``
PORTED_IN_A5 = ("BatchNormalization", "CenterLossOutputLayer", "ScaleVertex",
                "L2NormalizeVertex")


@pytest.mark.parametrize("name", PORTED_IN_A5)
def test_a_class_ported_in_a5_round_trips_the_jax_json(name):
    assert name in T and name not in tserde.NOT_PORTED
    payload = jserde.to_json(_jax_instance(name))
    obj = tserde.from_json(payload)
    assert type(obj) is T[name]
    assert json.loads(tserde.to_json(obj)) == json.loads(payload)
    back = jserde.from_json(tserde.to_json(obj))
    assert json.loads(jserde.to_json(back)) == json.loads(payload)


def test_the_classes_left_of_a5_raise_naming_it():
    """None is left: no entry of ``NOT_PORTED`` names A5, and no raise in
    the port names it."""
    assert "A5" not in set(tserde.NOT_PORTED.values())
    import pathlib
    import re
    pkg = pathlib.Path(tserde.__file__).resolve().parents[2]
    hits = [f"{f.name}:{i}" for f in pkg.rglob("*.py")
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if re.search(r"ROADMAP A5\b", line)]
    assert hits == []


def test_the_lacking_classes_are_the_listed_ones():
    assert set(LACKING) == set(tserde.NOT_PORTED)
    with pytest.raises(ValueError, match="Unknown config class"):
        tserde.lookup("NoSuchLayer")


def test_v1_payload_reads_with_the_v2_defaults():
    payload = json.dumps({"format_version": 1, "config": {
        "@class": "SubsamplingLayer", "pooling_type": "avg",
        "kernel_size": [3, 3], "stride": [1, 1], "padding": [1, 1],
        "convolution_mode": "same", "pnorm": 2, "unknown_key": 1}})
    t, j = tserde.from_json(payload), jserde.from_json(payload)
    assert t.avg_pool_include_pad_in_divisor is True
    assert j.avg_pool_include_pad_in_divisor is True
    assert json.loads(tserde.to_json(t)) == json.loads(jserde.to_json(j))
    assert json.loads(tserde.to_json(t))["format_version"] == \
        tserde.CONFIG_FORMAT_VERSION == jserde.CONFIG_FORMAT_VERSION == 2


def test_no_parameter_or_buffer_is_serialized():
    net = tzoo.transformer_lm(vocab_size=20, d_model=16, n_heads=2,
                              n_blocks=1, max_length=16, device="cpu").init()
    seen = []

    def walk(d):
        if isinstance(d, dict):
            if "@class" in d:
                seen.append(d["@class"])
                assert set(d) == {"@class"} | set(
                    tserde.field_names(T[d["@class"]])), d["@class"]
            for v in d.values():
                walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(json.loads(net.conf.to_json()))
    assert "SelfAttentionLayer" in seen and "LayerVertex" in seen


@pytest.mark.parametrize("kind", ["activation", "loss"])
def test_every_activation_and_loss_name_crosses(kind):
    if kind == "activation":
        names = jact.activation_names()
        assert names == tact.activation_names()
        objs = [("DenseLayer", dict(n_in=2, n_out=2, activation=n))
                for n in names]
    else:
        names = jloss.loss_names()
        assert names == tloss.loss_names()
        objs = [("OutputLayer", dict(n_in=2, n_out=2, loss=n))
                for n in names]
    for cls_name, kw in objs:
        jjson = jserde.to_json(J[cls_name](**kw))
        assert json.loads(tserde.to_json(tserde.from_json(jjson))) == \
            json.loads(jjson)
