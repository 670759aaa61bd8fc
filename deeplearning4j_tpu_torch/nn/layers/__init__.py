"""Layers of the port (counterpart of ``deeplearning4j_tpu/nn/layers``)."""
from .attention import SelfAttentionLayer
from .base import LayerConf
from .core import (DenseLayer, EmbeddingSequenceLayer,
                   PositionalEmbeddingLayer, RnnOutputLayer)
from .norm import LayerNormalization
from .recurrent import (GravesBidirectionalLSTM, GravesLSTM, LastTimeStepLayer,
                        LSTM)

__all__ = ["LayerConf", "DenseLayer", "EmbeddingSequenceLayer",
           "PositionalEmbeddingLayer", "RnnOutputLayer",
           "LayerNormalization", "SelfAttentionLayer", "LSTM", "GravesLSTM",
           "GravesBidirectionalLSTM", "LastTimeStepLayer"]
