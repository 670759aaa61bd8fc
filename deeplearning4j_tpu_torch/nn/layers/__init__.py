"""Layers of the port (counterpart of ``deeplearning4j_tpu/nn/layers``)."""
from .attention import SelfAttentionLayer
from .base import LayerConf
from .conv import (Convolution1DLayer, ConvolutionLayer, GlobalPoolingLayer,
                   Subsampling1DLayer, SubsamplingLayer, ZeroPadding1DLayer,
                   ZeroPaddingLayer)
from .core import (ActivationLayer, CenterLossOutputLayer, DenseLayer,
                   EmbeddingSequenceLayer, OutputLayer,
                   PositionalEmbeddingLayer, RnnOutputLayer)
from .norm import (BatchNormalization, LayerNormalization,
                   LocalResponseNormalization)
from .recurrent import (GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer,
                        LSTM)

__all__ = ["LayerConf", "DenseLayer", "ActivationLayer", "OutputLayer",
           "EmbeddingSequenceLayer", "PositionalEmbeddingLayer",
           "RnnOutputLayer", "CenterLossOutputLayer", "BatchNormalization",
           "LayerNormalization",
           "LocalResponseNormalization", "SelfAttentionLayer", "LSTM",
           "GravesLSTM", "GravesBidirectionalLSTM", "LastTimeStepLayer",
           "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
           "GlobalPoolingLayer", "Convolution1DLayer", "Subsampling1DLayer",
           "ZeroPadding1DLayer"]
