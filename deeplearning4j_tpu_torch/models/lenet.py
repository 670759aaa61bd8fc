"""LeNet and the 8x8 digits CNN, two ``MultiLayerNetwork``s.

Counterpart of ``deeplearning4j_tpu/models/lenet.py``: ``lenet`` (the
reference zoo's LeNet: conv 5x5/20, max pool, conv 5x5/50, max pool,
Dense(500), softmax) and ``digits_cnn`` (the LeNet-family CNN for the
8x8 handwritten digits), with the same keyword arguments, plus the
``device`` the network lives on (default: the CUDA card). Both start from
random weights from their seed; call ``init()`` to create them.
``digits_cnn(pretrained=True)`` needs the pretrained-weight machinery
(``models/pretrained.py``), which is ROADMAP A9; a trained model zip of
it (the JAX package's committed one) restores through
``util/serialization.py``.
"""
from __future__ import annotations

from ..device import DeviceLike
from ..nn.conf.config import NeuralNetConfiguration
from ..nn.inputs import InputType
from ..nn.layers import (ConvolutionLayer, DenseLayer, OutputLayer,
                         SubsamplingLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..optimize.updaters import Adam


def lenet(n_classes: int = 10, *, height: int = 28, width: int = 28,
          channels: int = 1, seed: int = 42, updater=None,
          dtype: str = "float32",
          device: DeviceLike = None) -> MultiLayerNetwork:
    """Reference zoo/model/LeNet.java."""
    conf = (NeuralNetConfiguration(
                seed=seed, updater=updater or Adam(1e-3),
                weight_init="xavier", activation="identity", dtype=dtype)
            .list(
                ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                 convolution_mode="same", activation="relu"),
                SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)),
                ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                 convolution_mode="same", activation="relu"),
                SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)),
                DenseLayer(n_out=500, activation="relu"),
                OutputLayer(n_out=n_classes, activation="softmax",
                            loss="mcxent"))
            .set_input_type(InputType.convolutional(height, width, channels))
            .build())
    return MultiLayerNetwork(conf, device=device)


def digits_cnn(*, pretrained: bool = False, seed: int = 7, updater=None,
               dtype: str = "float32",
               device: DeviceLike = None) -> MultiLayerNetwork:
    """The LeNet-family CNN for 8x8 handwritten digits (the UCI optical
    digits set): conv 3x3/16, max pool, conv 3x3/32, max pool, Dense(64),
    softmax(10)."""
    if pretrained:
        raise NotImplementedError(
            "digits_cnn(pretrained=True): the pretrained-weight machinery "
            "(models/pretrained.py) is not ported yet (ROADMAP A9); a "
            "trained model zip restores with "
            "util/serialization.py restore_multilayer_network")
    conf = (NeuralNetConfiguration(
                seed=seed, updater=updater or Adam(1e-3), dtype=dtype)
            .list(
                ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                 convolution_mode="same", activation="relu"),
                SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)),
                ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                 convolution_mode="same", activation="relu"),
                SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                 stride=(2, 2)),
                DenseLayer(n_out=64, activation="relu"),
                OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    return MultiLayerNetwork(conf, device=device)
