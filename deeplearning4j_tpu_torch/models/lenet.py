"""LeNet and the 8x8 digits CNN, two ``MultiLayerNetwork``s.

Counterpart of ``deeplearning4j_tpu/models/lenet.py``: ``lenet`` (the
reference zoo's LeNet: conv 5x5/20, max pool, conv 5x5/50, max pool,
Dense(500), softmax) and ``digits_cnn`` (the LeNet-family CNN for the
8x8 handwritten digits), with the same keyword arguments, plus the
``device`` the network lives on (default: the CUDA card). Both start from
random weights from their seed; call ``init()`` to create them.
``digits_cnn(pretrained=True)`` restores the committed trained weights
(``artifacts/digits_cnn.zip``, the reference's artifact byte for byte)
through ``models/pretrained.py`` after its Adler32 checksum is verified.
"""
from __future__ import annotations

import os

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


# Committed pretrained artifact for digits_cnn — TRAINED weights (the
# reference's tools/train_pretrained_digits.py: UCI optical digits, 1,797
# real 8x8 handwritten scans via scikit-learn; 1,397 train / 400 held out),
# a byte-for-byte copy of the reference's. The checksum is pinned in code
# like the reference's TrainedModels.java VGG16 constant; init_pretrained
# verifies it (ZooModel.java:40-52 contract).
DIGITS_CNN_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "artifacts", "digits_cnn.zip")
DIGITS_CNN_CHECKSUM = 193097393


def digits_cnn(*, pretrained: bool = False, seed: int = 7, updater=None,
               dtype: str = "float32",
               device: DeviceLike = None) -> MultiLayerNetwork:
    """The LeNet-family CNN for 8x8 handwritten digits (the UCI optical
    digits set): conv 3x3/16, max pool, conv 3x3/32, max pool, Dense(64),
    softmax(10). ``pretrained=True`` restores the committed trained weights
    (>= 0.97 held-out accuracy on real scans) after an Adler32 checksum
    verification — the reference zoo's initPretrained contract
    (zoo/ZooModel.java:40-81)."""
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
    net = MultiLayerNetwork(conf, device=device)
    if pretrained:
        from .pretrained import init_pretrained
        net.init()
        init_pretrained(net, DIGITS_CNN_ARTIFACT,
                        checksum=DIGITS_CNN_CHECKSUM)
    return net
