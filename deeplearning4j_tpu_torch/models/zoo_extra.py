"""Zoo models of the port: the GravesLSTM char-RNN and the decoder-only
transformer LM.

Counterpart of ``text_generation_lstm`` and ``sample_text``
(``deeplearning4j_tpu/models/zoo_extra.py:285-330``) and ``transformer_lm``
(``:333-393``), with the same keyword arguments, layers, vertex names and
input forms, plus the ``device`` the network lives on.
"""
from __future__ import annotations

import numpy as np

from ..device import DeviceLike
from ..nn.conf.config import NeuralNetConfiguration
from ..nn.graph.graph import ComputationGraph
from ..nn.graph.vertices import ElementWiseVertex
from ..nn.inputs import InputType
from ..nn.layers import (DenseLayer, EmbeddingSequenceLayer, GravesLSTM,
                         LayerNormalization, PositionalEmbeddingLayer,
                         RnnOutputLayer, SelfAttentionLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..optimize.updaters import Adam, RmsProp


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
