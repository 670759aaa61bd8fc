"""Layers of the port (counterpart of ``deeplearning4j_tpu/nn/layers``)."""
from .attention import SelfAttentionLayer
from .base import LayerConf
from .conv import (Convolution1DLayer, ConvolutionLayer, GlobalPoolingLayer,
                   Subsampling1DLayer, SubsamplingLayer, ZeroPadding1DLayer,
                   ZeroPaddingLayer)
from .core import (ActivationLayer, AutoEncoder, CenterLossOutputLayer,
                   DenseLayer, DropoutLayer, EmbeddingLayer,
                   EmbeddingSequenceLayer, LossLayer, OutputLayer,
                   PositionalEmbeddingLayer, RnnOutputLayer)
from .norm import (BatchNormalization, LayerNormalization,
                   LocalResponseNormalization)
from .recurrent import (GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer,
                        LSTM)
from .variational import (RBM, BernoulliReconstructionDistribution,
                          CompositeReconstructionDistribution,
                          ExponentialReconstructionDistribution,
                          GaussianReconstructionDistribution,
                          LossFunctionWrapper, VariationalAutoencoder)

__all__ = ["LayerConf", "DenseLayer", "ActivationLayer", "OutputLayer",
           "EmbeddingSequenceLayer", "PositionalEmbeddingLayer",
           "RnnOutputLayer", "CenterLossOutputLayer", "BatchNormalization",
           "LayerNormalization",
           "LocalResponseNormalization", "SelfAttentionLayer", "LSTM",
           "GravesLSTM", "GravesBidirectionalLSTM", "LastTimeStepLayer",
           "ConvolutionLayer", "SubsamplingLayer", "ZeroPaddingLayer",
           "GlobalPoolingLayer", "Convolution1DLayer", "Subsampling1DLayer",
           "ZeroPadding1DLayer", "DropoutLayer", "EmbeddingLayer",
           "LossLayer", "AutoEncoder", "VariationalAutoencoder", "RBM",
           "GaussianReconstructionDistribution",
           "BernoulliReconstructionDistribution",
           "ExponentialReconstructionDistribution",
           "CompositeReconstructionDistribution", "LossFunctionWrapper"]
