"""Zoo models of the port: GoogLeNet, Inception-ResNet-v1, FaceNet
nn4.small2, the GravesLSTM char-RNN and the decoder-only transformer LM.

Counterpart of ``_inception_v1`` and ``googlenet``
(``deeplearning4j_tpu/models/zoo_extra.py:31-105``),
``inception_resnet_v1`` and ``facenet_nn4_small2`` (``:109-283``),
``text_generation_lstm`` and ``sample_text`` (``:285-330``) and
``transformer_lm`` (``:333-393``), with the same keyword arguments,
layers, vertex names and input forms, plus the ``device`` the network
lives on.
"""
from __future__ import annotations

import numpy as np

from ..device import DeviceLike
from ..nn.conf.config import NeuralNetConfiguration
from ..nn.graph.graph import ComputationGraph
from ..nn.graph.vertices import (ElementWiseVertex, L2NormalizeVertex,
                                 MergeVertex, ScaleVertex)
from ..nn.inputs import InputType
from ..nn.layers import (ActivationLayer, BatchNormalization,
                         CenterLossOutputLayer, ConvolutionLayer, DenseLayer,
                         EmbeddingSequenceLayer, GlobalPoolingLayer,
                         GravesLSTM, LayerNormalization,
                         LocalResponseNormalization, OutputLayer,
                         PositionalEmbeddingLayer, RnnOutputLayer,
                         SelfAttentionLayer, SubsamplingLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..optimize.updaters import Adam, Nesterovs, RmsProp
from .zoo import _base_builder, _graph


def _inception_v1(g, name, inp, cfg):
    """One GoogLeNet inception module (reference GoogLeNet.java:125-140):
    cfg = [[c1x1], [c3x3_reduce, c3x3], [c5x5_reduce, c5x5], [pool_proj]].
    Its four 1x1 convs (bias, relu) take K7."""
    def conv(n_out, k):
        return ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                                convolution_mode="same", activation="relu",
                                bias_init=0.2)
    g.add_layer(f"{name}-cnn1", conv(cfg[0][0], 1), inp)
    g.add_layer(f"{name}-cnn2", conv(cfg[1][0], 1), inp)
    g.add_layer(f"{name}-cnn3", conv(cfg[2][0], 1), inp)
    g.add_layer(f"{name}-max1", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(1, 1),
        convolution_mode="same"), inp)
    g.add_layer(f"{name}-cnn4", conv(cfg[1][1], 3), f"{name}-cnn2")
    g.add_layer(f"{name}-cnn5", conv(cfg[2][1], 5), f"{name}-cnn3")
    g.add_layer(f"{name}-cnn6", conv(cfg[3][0], 1), f"{name}-max1")
    g.add_vertex(f"{name}-depthconcat1", MergeVertex(),
                 f"{name}-cnn1", f"{name}-cnn4", f"{name}-cnn5",
                 f"{name}-cnn6")
    return f"{name}-depthconcat1"


def googlenet(n_classes: int = 1000, *, height: int = 224, width: int = 224,
              channels: int = 3, seed: int = 42, updater=None,
              dtype: str = "float32",
              device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/GoogLeNet.java conf() :144-176, NHWC: a 7x7/2
    stem, LRN, nine inception modules, global average pooling, a
    dropout-0.4 Dense(1024) and a softmax output; l2 2e-4 and
    ``Nesterovs(1e-2, momentum=0.9)`` unless ``updater`` is given. Its 37
    1x1 convs with bias and relu (cnn2 and four in each module) take K7.
    The graph lives on ``device`` (default: the CUDA card); call
    ``init()`` to create its parameters."""
    g = _base_builder(seed, updater or Nesterovs(1e-2, momentum=0.9), dtype,
                      l2=2e-4)
    g.add_inputs("input")
    g.add_layer("cnn1", ConvolutionLayer(n_out=64, kernel_size=(7, 7),
                                         stride=(2, 2), convolution_mode="same",
                                         activation="relu", bias_init=0.2),
                "input")
    g.add_layer("max1", SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                         stride=(2, 2), convolution_mode="same"),
                "cnn1")
    g.add_layer("lrn1", LocalResponseNormalization(n=5, alpha=1e-4, beta=0.75),
                "max1")
    g.add_layer("cnn2", ConvolutionLayer(n_out=64, kernel_size=(1, 1),
                                         convolution_mode="same",
                                         activation="relu", bias_init=0.2),
                "lrn1")
    g.add_layer("cnn3", ConvolutionLayer(n_out=192, kernel_size=(3, 3),
                                         convolution_mode="same",
                                         activation="relu", bias_init=0.2),
                "cnn2")
    g.add_layer("lrn2", LocalResponseNormalization(n=5, alpha=1e-4, beta=0.75),
                "cnn3")
    g.add_layer("max2", SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                         stride=(2, 2), convolution_mode="same"),
                "lrn2")
    x = _inception_v1(g, "3a", "max2", [[64], [96, 128], [16, 32], [32]])
    x = _inception_v1(g, "3b", x, [[128], [128, 192], [32, 96], [64]])
    g.add_layer("max3", SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                         stride=(2, 2), convolution_mode="same"),
                x)
    x = _inception_v1(g, "4a", "max3", [[192], [96, 208], [16, 48], [64]])
    x = _inception_v1(g, "4b", x, [[160], [112, 224], [24, 64], [64]])
    x = _inception_v1(g, "4c", x, [[128], [128, 256], [24, 64], [64]])
    x = _inception_v1(g, "4d", x, [[112], [144, 288], [32, 64], [64]])
    x = _inception_v1(g, "4e", x, [[256], [160, 320], [32, 128], [128]])
    g.add_layer("max4", SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                         stride=(2, 2), convolution_mode="same"),
                x)
    x = _inception_v1(g, "5a", "max4", [[256], [160, 320], [32, 128], [128]])
    x = _inception_v1(g, "5b", x, [[384], [192, 384], [48, 128], [128]])
    g.add_layer("avg3", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("fc1", DenseLayer(n_out=1024, activation="relu", dropout=0.4),
                "avg3")
    g.add_layer("output", OutputLayer(n_out=n_classes, activation="softmax",
                                      loss="mcxent", weight_init="xavier"),
                "fc1")
    g.set_outputs("output")
    g.set_input_types(InputType.convolutional(height, width, channels))
    return ComputationGraph(g.build(), device=device)


# ------------------------------------------------------------ InceptionResNetV1
def _conv_bn_ir(g, name, inp, n_out, kernel, stride=(1, 1), act="relu"):
    g.add_layer(f"{name}", ConvolutionLayer(
        n_out=n_out, kernel_size=kernel, stride=stride,
        convolution_mode="same"), inp)
    g.add_layer(f"{name}-bn", BatchNormalization(activation=act, eps=1e-3,
                                                 decay=0.995), f"{name}")
    return f"{name}-bn"


def _ires_block(g, name, inp, branches, merge_to, scale):
    """One Inception-ResNet residual block (reference InceptionResNetHelper
    inceptionV1Res{A,B,C}): parallel conv-BN branches, a merge, a
    projection back to the trunk's width, a ``ScaleVertex``, the residual
    add and tanh."""
    ends = []
    for bi, chain in enumerate(branches):
        x = inp
        for ci, (n_out, kernel) in enumerate(chain):
            x = _conv_bn_ir(g, f"{name}-b{bi}c{ci}", x, n_out, kernel)
        ends.append(x)
    g.add_vertex(f"{name}-merge", MergeVertex(), *ends)
    proj_out, proj_kernel = merge_to
    x = _conv_bn_ir(g, f"{name}-proj", f"{name}-merge", proj_out, proj_kernel,
                    act="identity")
    g.add_vertex(f"{name}-scale", ScaleVertex(scale_factor=scale), x)
    g.add_vertex(f"{name}-add", ElementWiseVertex(op="add"), f"{name}-scale",
                 inp)
    g.add_layer(f"{name}", ActivationLayer(activation="tanh"), f"{name}-add")
    return f"{name}"


def inception_resnet_v1(n_classes: int = 1000, *, height: int = 160,
                        width: int = 160, channels: int = 3,
                        embedding_size: int = 128, seed: int = 42,
                        updater=None, dtype: str = "float32",
                        res_a: int = 5, res_b: int = 10, res_c: int = 5,
                        device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/InceptionResNetV1.java: the FaceNet-style
    Inception-ResNet with an L2-normalized embedding and a center-loss
    softmax head; 5/10/5 blocks (smaller counts give test-sized
    instantiations); ``RmsProp(0.1)`` unless ``updater`` is given."""
    g = _base_builder(seed, updater or RmsProp(0.1), dtype)
    g.add_inputs("input")
    x = _conv_bn_ir(g, "stem-1", "input", 32, (3, 3), (2, 2))
    x = _conv_bn_ir(g, "stem-2", x, 32, (3, 3))
    x = _conv_bn_ir(g, "stem-3", x, 64, (3, 3))
    g.add_layer("stem-pool", SubsamplingLayer(pooling_type="max",
                                              kernel_size=(3, 3),
                                              stride=(2, 2),
                                              convolution_mode="same"), x)
    x = _conv_bn_ir(g, "stem-5", "stem-pool", 80, (1, 1))
    x = _conv_bn_ir(g, "stem-6", x, 128, (3, 3))
    x = _conv_bn_ir(g, "stem-7", x, 192, (3, 3), (2, 2))
    for i in range(res_a):
        x = _ires_block(g, f"resA{i}", x,
                        branches=[[(32, (1, 1))],
                                  [(32, (1, 1)), (32, (3, 3))],
                                  [(32, (1, 1)), (32, (3, 3)),
                                   (32, (3, 3))]],
                        merge_to=(192, (3, 3)), scale=0.17)
    ra1 = _conv_bn_ir(g, "reduceA-1", x, 192, (3, 3), (2, 2))
    ra2 = _conv_bn_ir(g, "reduceA-2a", x, 128, (1, 1))
    ra2 = _conv_bn_ir(g, "reduceA-2b", ra2, 128, (3, 3))
    ra2 = _conv_bn_ir(g, "reduceA-2c", ra2, 192, (3, 3), (2, 2))
    g.add_layer("reduceA-pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    g.add_vertex("reduceA", MergeVertex(), ra1, ra2, "reduceA-pool")
    x = "reduceA"
    for i in range(res_b):
        x = _ires_block(g, f"resB{i}", x,
                        branches=[[(128, (1, 1))],
                                  [(128, (1, 1)), (128, (1, 3)),
                                   (128, (3, 1))]],
                        merge_to=(576, (1, 1)), scale=0.10)
    g.add_layer("reduceB-pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    rb2 = _conv_bn_ir(g, "reduceB-2a", x, 256, (1, 1))
    rb2 = _conv_bn_ir(g, "reduceB-2b", rb2, 256, (3, 3), (2, 2))
    rb3 = _conv_bn_ir(g, "reduceB-3a", x, 256, (1, 1))
    rb3 = _conv_bn_ir(g, "reduceB-3b", rb3, 256, (3, 3), (2, 2))
    rb4 = _conv_bn_ir(g, "reduceB-4a", x, 256, (1, 1))
    rb4 = _conv_bn_ir(g, "reduceB-4b", rb4, 256, (3, 3))
    rb4 = _conv_bn_ir(g, "reduceB-4c", rb4, 256, (3, 3), (2, 2))
    g.add_vertex("reduceB", MergeVertex(), "reduceB-pool", rb2, rb3, rb4)
    x = "reduceB"
    for i in range(res_c):
        x = _ires_block(g, f"resC{i}", x,
                        branches=[[(192, (1, 1))],
                                  [(192, (1, 1)), (192, (1, 3)),
                                   (192, (3, 1))]],
                        merge_to=(1344, (1, 1)), scale=0.20)
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("bottleneck", DenseLayer(n_out=embedding_size,
                                         activation="identity"), "avgpool")
    g.add_vertex("embeddings", L2NormalizeVertex(eps=1e-10), "bottleneck")
    g.add_layer("outputLayer", CenterLossOutputLayer(
        n_out=n_classes, activation="softmax", loss="mcxent", alpha=0.9,
        lambda_=1e-4, weight_init="xavier"), "embeddings")
    g.set_outputs("outputLayer")
    return _graph(g, height, width, channels, device)


# ------------------------------------------------------------ FaceNetNN4Small2
def _facenet_inception(g, name, inp, b1, b3r, b3, b5r, b5, pool_proj,
                       stride=(1, 1)):
    """The OpenFace nn4-style BN-inception module (reference
    zoo/model/helper/FaceNetHelper.java appendGraph): each conv branch is
    conv, BN, relu; the stride-2 reductions drop the 1x1 branch."""
    ends = []
    if b1:
        ends.append(_conv_bn_ir(g, f"{name}-1x1", inp, b1, (1, 1)))
    x = _conv_bn_ir(g, f"{name}-3x3r", inp, b3r, (1, 1))
    ends.append(_conv_bn_ir(g, f"{name}-3x3", x, b3, (3, 3), stride))
    if b5r:
        x = _conv_bn_ir(g, f"{name}-5x5r", inp, b5r, (1, 1))
        ends.append(_conv_bn_ir(g, f"{name}-5x5", x, b5, (5, 5), stride))
    g.add_layer(f"{name}-pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=stride,
        convolution_mode="same"), inp)
    if pool_proj:
        ends.append(_conv_bn_ir(g, f"{name}-poolproj", f"{name}-pool",
                                pool_proj, (1, 1)))
    else:
        ends.append(f"{name}-pool")
    g.add_vertex(f"{name}", MergeVertex(), *ends)
    return f"{name}"


def facenet_nn4_small2(n_classes: int = 1000, *, height: int = 96,
                       width: int = 96, channels: int = 3,
                       embedding_size: int = 128, seed: int = 42,
                       updater=None, dtype: str = "float32",
                       device: DeviceLike = None) -> ComputationGraph:
    """Reference zoo/model/FaceNetNN4Small2.java: OpenFace nn4.small2 with
    center-loss embedding training; ``Adam(1e-3)`` unless ``updater`` is
    given."""
    g = _base_builder(seed, updater or Adam(1e-3), dtype)
    g.add_inputs("input")
    x = _conv_bn_ir(g, "stem-cnn1", "input", 64, (7, 7), (2, 2))
    g.add_layer("stem-pool1", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), x)
    g.add_layer("stem-lrn1", LocalResponseNormalization(
        n=5, alpha=1e-4, beta=0.75), "stem-pool1")
    x = _conv_bn_ir(g, "inception-2-cnn1", "stem-lrn1", 64, (1, 1))
    x = _conv_bn_ir(g, "inception-2-cnn2", x, 192, (3, 3))
    g.add_layer("inception-2-lrn1", LocalResponseNormalization(
        n=5, alpha=1e-4, beta=0.75), x)
    g.add_layer("inception-2-pool1", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), "inception-2-lrn1")
    x = _facenet_inception(g, "inception-3a", "inception-2-pool1",
                           64, 96, 128, 16, 32, 32)
    x = _facenet_inception(g, "inception-3b", x, 64, 96, 128, 32, 64, 64)
    x = _facenet_inception(g, "inception-3c", x, 0, 128, 256, 32, 64, 0,
                           stride=(2, 2))
    x = _facenet_inception(g, "inception-4a", x, 256, 96, 192, 32, 64, 128)
    x = _facenet_inception(g, "inception-4e", x, 0, 160, 256, 64, 128, 0,
                           stride=(2, 2))
    x = _facenet_inception(g, "inception-5a", x, 256, 96, 384, 0, 0, 96)
    x = _facenet_inception(g, "inception-5b", x, 256, 96, 384, 0, 0, 96)
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("bottleneck", DenseLayer(n_out=embedding_size,
                                         activation="identity"), "avgpool")
    g.add_vertex("embeddings", L2NormalizeVertex(eps=1e-10), "bottleneck")
    g.add_layer("lossLayer", CenterLossOutputLayer(
        n_out=n_classes, activation="softmax", loss="mcxent", alpha=0.9,
        lambda_=1e-4, weight_init="xavier"), "embeddings")
    g.set_outputs("lossLayer")
    return _graph(g, height, width, channels, device)


def text_generation_lstm(vocab_size: int = 77, *, hidden: int = 256,
                         max_length: int = 40, tbptt_length: int = 50,
                         seed: int = 12345, updater=None,
                         dtype: str = "float32",
                         device: DeviceLike = None) -> MultiLayerNetwork:
    """Reference zoo/model/TextGenerationLSTM.java conf() :76-92:
    GravesLSTM(hidden) x2 + a time-distributed softmax over one-hot
    characters, l2 1e-3, RmsProp(1e-3) unless ``updater`` is given, tBPTT
    in chunks of ``tbptt_length`` steps. Its recurrences take the K5/K6
    kernels where ``ops.lstm.fused_lstm_applicable`` admits them. The
    network lives on ``device`` (default: the CUDA card); call ``init()``
    to create its parameters."""
    b = (NeuralNetConfiguration(seed=seed, updater=updater or RmsProp(1e-3),
                                l2=1e-3, weight_init="xavier", dtype=dtype)
         .list(GravesLSTM(n_out=hidden, activation="tanh"),
               GravesLSTM(n_out=hidden, activation="tanh"),
               RnnOutputLayer(n_out=vocab_size, activation="softmax",
                              loss="mcxent"))
         .set_input_type(InputType.recurrent(vocab_size, max_length))
         .tbptt_length(tbptt_length))
    return MultiLayerNetwork(b.build(), device=device)


def sample_text(net, *, vocab_size: int, seed_ids, n_steps: int,
                temperature: float = 1.0, rng_seed: int = 0):
    """Generate ``n_steps`` token ids from a char-RNN through the streaming
    ``rnn_time_step``: prime the state with ``seed_ids`` (one-hot, one step
    at a time), then draw each next id from the softmax re-tempered as
    p_i ∝ p_i^(1/temperature) with numpy's ``default_rng(rng_seed)``, as
    the reference draws, so equal probabilities give equal ids."""
    rng = np.random.default_rng(rng_seed)
    net.rnn_clear_previous_state()

    def step(tok):
        x = np.zeros((1, vocab_size), np.float32)
        x[0, int(tok)] = 1.0
        return net.rnn_time_step(x)[0].float().cpu().numpy()

    probs = None
    for t in seed_ids:
        probs = step(t)
    out = []
    for _ in range(n_steps):
        if probs is None:
            probs = np.full(vocab_size, 1.0 / vocab_size)
        p = np.clip(probs, 1e-12, None) ** (1.0 / max(temperature, 1e-6))
        p /= p.sum()
        nxt = int(rng.choice(vocab_size, p=p))
        out.append(nxt)
        probs = step(nxt)
    return out


def transformer_lm(vocab_size: int = 256, *, d_model: int = 256,
                   n_heads: int = 2, n_blocks: int = 2,
                   max_length: int = 1024, seed: int = 12345, updater=None,
                   dtype: str = "float32", token_input: bool = False,
                   device: DeviceLike = None) -> ComputationGraph:
    """Decoder-only transformer LM: pre-LN blocks of causal self-attention
    and a gelu MLP with residual adds, a LayerNorm and a time-distributed
    softmax head. Its attention takes the flash-attention kernel where
    ``ops.flash_attention.fused_attention_applicable`` admits the shapes.

    ``token_input=True`` feeds [B,T] integer token ids through an
    EmbeddingSequenceLayer gather; the default takes one-hot [B,T,V].
    The graph lives on ``device`` (default: the CUDA card); call ``init()``
    to create its parameters. ``updater`` defaults to ``Adam(3e-4)``, as
    the reference's does."""
    embed = (EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model)
             if token_input
             else DenseLayer(n_out=d_model, activation="identity"))
    g = (_base_builder(seed, updater or Adam(3e-4), dtype=dtype)
         .add_inputs("tokens")
         .add_layer("embed", embed, "tokens")
         .add_layer("pos", PositionalEmbeddingLayer(n_out=d_model,
                                                    max_length=max_length),
                    "embed"))
    h = "pos"
    for i in range(n_blocks):
        g = (g
             .add_layer(f"b{i}_ln1", LayerNormalization(n_out=d_model), h)
             .add_layer(f"b{i}_attn",
                        SelfAttentionLayer(n_out=d_model, n_heads=n_heads,
                                           causal=True), f"b{i}_ln1")
             .add_vertex(f"b{i}_add1", ElementWiseVertex("add"),
                         h, f"b{i}_attn")
             .add_layer(f"b{i}_ln2", LayerNormalization(n_out=d_model),
                        f"b{i}_add1")
             .add_layer(f"b{i}_ff1",
                        DenseLayer(n_out=4 * d_model, activation="gelu"),
                        f"b{i}_ln2")
             .add_layer(f"b{i}_ff2",
                        DenseLayer(n_out=d_model, activation="identity"),
                        f"b{i}_ff1")
             .add_vertex(f"b{i}_add2", ElementWiseVertex("add"),
                         f"b{i}_add1", f"b{i}_ff2"))
        h = f"b{i}_add2"
    g = (g.add_layer("ln_f", LayerNormalization(n_out=d_model), h)
          .add_layer("head", RnnOutputLayer(n_out=vocab_size,
                                            activation="softmax",
                                            loss="mcxent"), "ln_f")
          .set_outputs("head")
          .set_input_types(InputType.recurrent(
              1 if token_input else vocab_size, max_length)))
    return ComputationGraph(g.build(), device=device)
