"""The model zoo's CNNs: ResNet-50, VGG-16, VGG-19, AlexNet and SimpleCNN.

Counterpart of ``deeplearning4j_tpu/models/zoo.py`` (``:27-187``): the same
builders with the same keyword arguments, defaults, layers and vertex
names (ResNet-50's convs without a bias, each followed by a
BatchNormalization), plus the ``device`` the network lives on (default:
the CUDA card). Every model is an NHWC ``ComputationGraph`` with random
weights from its seed; call ``init()`` to create them. Pretrained weights
load from a local model zip through ``models/pretrained.py``
``init_pretrained``, as in the reference. The builders' convs are 3x3 or
larger, or followed by a BatchNormalization, so none of them takes K7
(GoogLeNet's 1x1 convs do, ``models/zoo_extra.py``).
"""
from __future__ import annotations

from ..device import DeviceLike
from ..nn.conf.config import NeuralNetConfiguration
from ..nn.conf.graph_conf import GraphBuilder
from ..nn.graph.graph import ComputationGraph
from ..nn.graph.vertices import ElementWiseVertex
from ..nn.inputs import InputType
from ..nn.layers import (ActivationLayer, BatchNormalization, ConvolutionLayer,
                         DenseLayer, GlobalPoolingLayer,
                         LocalResponseNormalization, OutputLayer,
                         SubsamplingLayer)
from ..optimize.updaters import Adam, Nesterovs


def _base_builder(seed, updater, dtype="float32", **kw):
    """A graph builder with the zoo's defaults: relu weight init, identity
    activation, ``Adam(1e-3)`` unless ``updater`` is given."""
    return NeuralNetConfiguration(seed=seed, updater=updater or Adam(1e-3),
                                  weight_init="relu", activation="identity",
                                  dtype=dtype, **kw).graph_builder()


def _graph(g: GraphBuilder, height, width, channels,
           device: DeviceLike) -> ComputationGraph:
    g.set_input_types(InputType.convolutional(height, width, channels))
    return ComputationGraph(g.build(), device=device)


# --------------------------------------------------------------------- ResNet50
def _conv_bn(g: GraphBuilder, name, inp, n_out, kernel, stride, mode="same",
             relu=True):
    # no conv bias: the BatchNorm's beta that follows makes it redundant
    g.add_layer(f"{name}_conv", ConvolutionLayer(
        n_out=n_out, kernel_size=kernel, stride=stride, convolution_mode=mode,
        has_bias=False), inp)
    g.add_layer(f"{name}_bn", BatchNormalization(
        activation="relu" if relu else "identity"), f"{name}_conv")
    return f"{name}_bn"


def _res_conv_block(g, name, inp, filters, stride):
    f1, f2, f3 = filters
    x = _conv_bn(g, f"{name}_a", inp, f1, (1, 1), stride)
    x = _conv_bn(g, f"{name}_b", x, f2, (3, 3), (1, 1))
    x = _conv_bn(g, f"{name}_c", x, f3, (1, 1), (1, 1), relu=False)
    sc = _conv_bn(g, f"{name}_sc", inp, f3, (1, 1), stride, relu=False)
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def _res_identity_block(g, name, inp, filters):
    f1, f2, f3 = filters
    x = _conv_bn(g, f"{name}_a", inp, f1, (1, 1), (1, 1))
    x = _conv_bn(g, f"{name}_b", x, f2, (3, 3), (1, 1))
    x = _conv_bn(g, f"{name}_c", x, f3, (1, 1), (1, 1), relu=False)
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, inp)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def resnet50(n_classes: int = 1000, *, height: int = 224, width: int = 224,
             channels: int = 3, seed: int = 42, updater=None,
             dtype: str = "float32", compute_dtype=None,
             device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/ResNet50.java graphBuilder :82: a 7x7/2 stem
    with BatchNorm and a 3x3/2 max pool, stages of [3, 4, 6, 3] bottleneck
    blocks, global average pooling and a softmax output.
    ``compute_dtype='bfloat16'`` trains in mixed precision (float32
    master parameters)."""
    g = _base_builder(seed, updater, dtype, compute_dtype=compute_dtype)
    g.add_inputs("input")
    x = _conv_bn(g, "stem", "input", 64, (7, 7), (2, 2))
    g.add_layer("stem_pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    x = "stem_pool"
    stages = [((64, 64, 256), 3, (1, 1)), ((128, 128, 512), 4, (2, 2)),
              ((256, 256, 1024), 6, (2, 2)), ((512, 512, 2048), 3, (2, 2))]
    for si, (filters, blocks, stride) in enumerate(stages):
        x = _res_conv_block(g, f"s{si}b0", x, filters, stride)
        for bi in range(1, blocks):
            x = _res_identity_block(g, f"s{si}b{bi}", x, filters)
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("fc", OutputLayer(n_out=n_classes, activation="softmax",
                                  loss="mcxent", weight_init="xavier"),
                "avgpool")
    g.set_outputs("fc")
    return _graph(g, height, width, channels, device)


# ----------------------------------------------------------------------- VGG
def _vgg(cfg, n_classes, height, width, channels, seed, updater, dtype,
         device):
    g = _base_builder(seed, updater, dtype)
    g.add_inputs("input")
    x = "input"
    for bi, (convs, n_out) in enumerate(cfg):
        for ci in range(convs):
            g.add_layer(f"b{bi}c{ci}", ConvolutionLayer(
                n_out=n_out, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), x)
            x = f"b{bi}c{ci}"
        g.add_layer(f"b{bi}pool", SubsamplingLayer(
            pooling_type="max", kernel_size=(2, 2), stride=(2, 2)), x)
        x = f"b{bi}pool"
    g.add_layer("fc1", DenseLayer(n_out=4096, activation="relu"), x)
    g.add_layer("fc2", DenseLayer(n_out=4096, activation="relu"), "fc1")
    g.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                   loss="mcxent", weight_init="xavier"), "fc2")
    g.set_outputs("out")
    return _graph(g, height, width, channels, device)


def vgg16(n_classes: int = 1000, *, height: int = 224, width: int = 224,
          channels: int = 3, seed: int = 42, updater=None, dtype="float32",
          device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/VGG16.java."""
    return _vgg([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)],
                n_classes, height, width, channels, seed, updater, dtype,
                device)


def vgg19(n_classes: int = 1000, *, height: int = 224, width: int = 224,
          channels: int = 3, seed: int = 42, updater=None, dtype="float32",
          device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/VGG19.java."""
    return _vgg([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)],
                n_classes, height, width, channels, seed, updater, dtype,
                device)


# --------------------------------------------------------------------- AlexNet
def alexnet(n_classes: int = 1000, *, height: int = 224, width: int = 224,
            channels: int = 3, seed: int = 42, updater=None, dtype="float32",
            device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/AlexNet.java (the LRN variant, its two columns
    collapsed into one); ``Nesterovs(1e-2, momentum=0.9)`` unless
    ``updater`` is given."""
    g = _base_builder(seed, updater or Nesterovs(1e-2, momentum=0.9), dtype)
    g.add_inputs("input")

    def conv(n_out, k, stride=(1, 1)):
        return ConvolutionLayer(n_out=n_out, kernel_size=k, stride=stride,
                                convolution_mode="same", activation="relu")

    def pool():
        return SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                stride=(2, 2))

    g.add_layer("c1", conv(96, (11, 11), (4, 4)), "input")
    g.add_layer("lrn1", LocalResponseNormalization(), "c1")
    g.add_layer("p1", pool(), "lrn1")
    g.add_layer("c2", conv(256, (5, 5)), "p1")
    g.add_layer("lrn2", LocalResponseNormalization(), "c2")
    g.add_layer("p2", pool(), "lrn2")
    g.add_layer("c3", conv(384, (3, 3)), "p2")
    g.add_layer("c4", conv(384, (3, 3)), "c3")
    g.add_layer("c5", conv(256, (3, 3)), "c4")
    g.add_layer("p5", pool(), "c5")
    g.add_layer("fc1", DenseLayer(n_out=4096, activation="relu", dropout=0.5),
                "p5")
    g.add_layer("fc2", DenseLayer(n_out=4096, activation="relu", dropout=0.5),
                "fc1")
    g.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                   loss="mcxent", weight_init="xavier"), "fc2")
    g.set_outputs("out")
    return _graph(g, height, width, channels, device)


# ------------------------------------------------------------------- SimpleCNN
def simple_cnn(n_classes: int = 10, *, height: int = 48, width: int = 48,
               channels: int = 3, seed: int = 42, updater=None,
               dtype="float32", device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/SimpleCNN.java: three conv + BatchNorm + max
    pool stages, a dropout-0.5 Dense(256) and a softmax output."""
    g = _base_builder(seed, updater, dtype)
    g.add_inputs("input")
    x = "input"
    for i, f in enumerate([16, 32, 64]):
        g.add_layer(f"c{i}", ConvolutionLayer(n_out=f, kernel_size=(3, 3),
                                              convolution_mode="same",
                                              activation="relu"), x)
        g.add_layer(f"bn{i}", BatchNormalization(), f"c{i}")
        g.add_layer(f"p{i}", SubsamplingLayer(pooling_type="max",
                                              kernel_size=(2, 2),
                                              stride=(2, 2)), f"bn{i}")
        x = f"p{i}"
    g.add_layer("fc", DenseLayer(n_out=256, activation="relu", dropout=0.5), x)
    g.add_layer("out", OutputLayer(n_out=n_classes, activation="softmax",
                                   loss="mcxent", weight_init="xavier"), "fc")
    g.set_outputs("out")
    return _graph(g, height, width, channels, device)
