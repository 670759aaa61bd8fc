"""Zoo models of the port: the decoder-only transformer LM.

Counterpart of ``transformer_lm`` in ``deeplearning4j_tpu/models/zoo_extra.py``
(``:333-393``), with the same keyword arguments, vertex names and both
input forms, plus the ``device`` the graph lives on.
"""
from __future__ import annotations

from ..device import DeviceLike
from ..nn.conf.config import NeuralNetConfiguration
from ..nn.graph.graph import ComputationGraph
from ..nn.graph.vertices import ElementWiseVertex
from ..nn.inputs import InputType
from ..nn.layers import (DenseLayer, EmbeddingSequenceLayer,
                         LayerNormalization, PositionalEmbeddingLayer,
                         RnnOutputLayer, SelfAttentionLayer)


def _base_builder(seed, updater, dtype="float32"):
    """The zoo's shared defaults (``models/zoo.py`` ``_base_builder``)."""
    return NeuralNetConfiguration(seed=seed, updater=updater,
                                  weight_init="relu", activation="identity",
                                  dtype=dtype).graph_builder()


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
    to create its parameters."""
    embed = (EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model)
             if token_input
             else DenseLayer(n_out=d_model, activation="identity"))
    g = (_base_builder(seed, updater, dtype=dtype)
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
