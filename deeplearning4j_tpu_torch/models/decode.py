"""Cache-aware autoregressive decode for the transformer LM and the
char-RNN.

Counterpart of ``deeplearning4j_tpu/models/decode.py``: the ``KVStore``
protocol (``:49``), ``window_attention`` (``:61``),
``TransformerDecodeSpec`` (``prefill_forward`` ``:167``, ``decode_step``
``:194``, ``_block_step`` ``:214``, ``decode_window`` / ``_block_window``
``:238-284``), ``LSTMDecodeSpec`` (``:286-366``), ``truncated_draft``
(``:370``), ``naive_generate`` (``:399``) and ``naive_generate_lstm``
(``:428-446``).

- ``prefill_forward`` runs the graph's own ``apply_fn`` over the padded
  prompt, so its logits are those of a plain ``net.output`` (and its
  attention takes the flash-attention kernel where the probe admits the
  shapes), and returns each block's K/V for the paged cache.
- ``decode_step`` feeds one token per sequence through a K/V store (the
  paged ``serving.generation.kvcache.PagedStore``) and replays each layer's
  own math position by position; its attention row is the plain
  ``parallel.ring_attention.attention`` over the gathered context.
- ``decode_window`` feeds W tokens per sequence in one pass (the
  speculative verify and the int8 tier's prefill) through a window store;
  every op is the batched form of ``decode_step``'s, and its attention is
  ``window_attention``, ``attention``'s arithmetic with a mask per query
  row.
- ``truncated_draft`` builds a speculative-decoding draft from a target's
  first blocks, its parameters copied by vertex name.
- ``naive_generate`` is the cache-free greedy reference: one full forward
  per emitted token.
- ``LSTMDecodeSpec`` serves a ``text_generation_lstm``-style
  MultiLayerNetwork: its cache is the per-layer recurrent state, fixed in
  shape. ``prefill_scan`` runs the padded prompt through each layer once,
  masked by ``t < length`` (one K5 launch per layer on the card, where the
  reference steps through the prompt one token at a time): masked steps
  carry the state through, so the final state and the last position's
  output are those at ``length - 1``. ``naive_generate_lstm`` is its greedy
  reference through the public ``rnn_time_step``.

Sharding the heads over a mesh (the reference's ``supports_head_sharding``)
is ROADMAP A7b.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, check_same_device, resolve_device
from ..nn.layers import (DenseLayer, EmbeddingSequenceLayer,
                         LayerNormalization, RnnOutputLayer,
                         SelfAttentionLayer)
from ..nn.multilayer import MultiLayerNetwork
from ..parallel.ring_attention import attention


class KVStore(Protocol):
    """What ``decode_step`` needs from a cache: write this step's K/V for
    layer ``i``, read back the full (gathered) K/V context and key mask."""

    def put_get(self, i: int, k_tok, v_tok) -> Tuple[Any, Any, Any]:
        """k_tok/v_tok: [B,H,Dh] for the current position. Returns
        (K [B,H,L,Dh], V [B,H,L,Dh], key_mask [B,L]) with the current
        position already visible."""
        ...


def window_attention(q, k, v, row_mask):
    """Row-masked softmax attention for a W-token decode window:
    q [B,H,W,Dh], k/v [B,H,L,Dh], row_mask [B,W,L] (True = visible).

    Mirrors ``parallel.ring_attention.attention``'s arithmetic (the same
    scale, the same -1e30 fill, the same softmax axis) with a mask per
    query row: row ``i`` seeing keys ``<= pos+i`` computes what the
    one-token ``attention(..., key_mask=)`` row computes, which keeps a
    batched speculative verify token for token with W decode steps."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(~row_mask[:, None, :, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v)


class TransformerDecodeSpec:
    """Vertex map of a ``models.transformer_lm`` graph, validated for the
    incremental decode path."""

    def __init__(self, net):
        self.net = net
        names = list(net.vertex_names)
        for required in ("embed", "pos", "ln_f", "head"):
            if required not in names:
                raise ValueError(
                    f"not a models.transformer_lm graph: vertex {required!r} "
                    f"missing (got {names})")
        self.n_blocks = 0
        while f"b{self.n_blocks}_attn" in names:
            self.n_blocks += 1
        if self.n_blocks == 0:
            raise ValueError("no attention blocks found (b0_attn missing)")
        self._layer = {n: net.vertices[n].layer for n in names
                       if hasattr(net.vertices[n], "layer")}
        embed = self._layer["embed"]
        self.token_input = isinstance(embed, EmbeddingSequenceLayer)
        if not self.token_input and not isinstance(embed, DenseLayer):
            raise ValueError(f"unsupported embed layer {type(embed).__name__}")
        attn0 = self._layer["b0_attn"]
        if not isinstance(attn0, SelfAttentionLayer) or not attn0.causal:
            raise ValueError("decode requires causal SelfAttentionLayer "
                             "blocks")
        if not isinstance(self._layer["head"], RnnOutputLayer):
            raise ValueError("decode requires an RnnOutputLayer head")
        if not isinstance(self._layer["ln_f"], LayerNormalization):
            raise ValueError("decode requires a LayerNormalization final "
                             "norm")
        self.n_heads = attn0.n_heads
        self.d_model = attn0.n_out
        self.head_dim = self.d_model // self.n_heads
        self.vocab = self._layer["head"].n_out
        self.max_length = self._layer["pos"].max_length
        self.dtype = net.dtype

    def _heads(self, x):
        """[B,T,d] -> [B,H,T,Dh] (SelfAttentionLayer._heads layout)."""
        B, T, _ = x.shape
        return x.reshape(B, T, self.n_heads, self.head_dim).transpose(1, 2)

    def graph_input(self, tokens):
        """[B,T] int token ids -> what the graph's input takes."""
        if self.token_input:
            return tokens
        return F.one_hot(tokens.long(), self.vocab).to(self.dtype)

    # ------------------------------------------------------------- prefill
    @torch.inference_mode()
    def prefill_forward(self, tokens):
        """Full forward over the padded prompt [B,L] through the graph's
        ``apply_fn``, plus the per-layer K/V for the cache. Returns
        (logits [B,L,V] pre-activation, ks, vs) with ks[i]/vs[i]
        [B,L,H,Dh]."""
        acts = self.net.apply_fn(self.graph_input(tokens))
        logits = self._layer["head"].pre_output(acts["ln_f"])
        ks, vs = [], []
        for i in range(self.n_blocks):
            attn = self._layer[f"b{i}_attn"]
            y = acts[f"b{i}_ln1"]
            B, L, _ = y.shape
            ks.append((y @ attn.Wk).reshape(B, L, self.n_heads,
                                            self.head_dim))
            vs.append((y @ attn.Wv).reshape(B, L, self.n_heads,
                                            self.head_dim))
        return logits, ks, vs

    # ---------------------------------------------------------- decode step
    @torch.inference_mode()
    def decode_step(self, tokens, pos, store):
        """One incremental step: ``tokens`` [B] int ids at positions ``pos``
        [B]. ``store.put_get(i, k_tok, v_tok)`` writes layer ``i``'s K/V
        ([B,H,Dh]) for this position, then returns the gathered,
        position-ordered context (K, V [B,H,L,Dh]) and its key mask [B,L].
        Returns pre-activation logits [B,V]."""
        x = self._layer["embed"](self.graph_input(tokens[:, None]))  # [B,1,d]
        pos_layer = self._layer["pos"]
        x = pos_layer.act(x + pos_layer.P[pos.long()][:, None, :])
        for i in range(self.n_blocks):
            x = self._block_step(i, x, store)
        y = self._layer["ln_f"](x)
        return self._layer["head"].pre_output(y)[:, 0, :]

    def _block_step(self, i, x, store):
        h = x
        y = self._layer[f"b{i}_ln1"](x)                        # [B,1,d]
        attn = self._layer[f"b{i}_attn"]
        B = y.shape[0]
        q = self._heads(y @ attn.Wq)                           # [B,H,1,Dh]
        k_tok = (y @ attn.Wk).reshape(B, self.n_heads, self.head_dim)
        v_tok = (y @ attn.Wv).reshape(B, self.n_heads, self.head_dim)
        K, V, key_mask = store.put_get(i, k_tok, v_tok)
        out = attention(q, K, V, causal=False, key_mask=key_mask)
        out = out.transpose(1, 2).reshape(B, 1, self.d_model)
        if attn.project_out:
            out = out @ attn.Wo + attn.b
        x = h + attn.act(out)                                  # b{i}_add1
        f = self._layer[f"b{i}_ff2"](
            self._layer[f"b{i}_ff1"](self._layer[f"b{i}_ln2"](x)))
        return x + f                                           # b{i}_add2

    # --------------------------------------------------------- decode window
    @torch.inference_mode()
    def decode_window(self, tokens, pos, store):
        """W tokens per sequence in ONE pass — the speculative-verify
        forward. ``tokens`` [B,W] are fed at positions ``pos .. pos+W-1``;
        ``store`` is a window store (``put_get`` takes [B,W,H,Dh] and
        returns per-row key masks). Every op is the [B,W,·] batched form
        of ``decode_step``'s (all non-attention ops are position-wise;
        attention rows carry their own masks). Returns pre-activation
        logits [B,W,V]."""
        B, W = tokens.shape
        x = self._layer["embed"](self.graph_input(tokens))     # [B,W,d]
        pos_layer = self._layer["pos"]
        w_pos = (pos.long()[:, None]
                 + torch.arange(W, device=tokens.device)[None, :])
        x = pos_layer.act(
            x + pos_layer.P[torch.clamp(w_pos, 0, pos_layer.P.shape[0] - 1)])
        for i in range(self.n_blocks):
            x = self._block_window(i, x, store)
        y = self._layer["ln_f"](x)
        return self._layer["head"].pre_output(y)

    def _block_window(self, i, x, store):
        h = x
        y = self._layer[f"b{i}_ln1"](x)                        # [B,W,d]
        attn = self._layer[f"b{i}_attn"]
        B, W, _ = y.shape
        q = self._heads(y @ attn.Wq)                           # [B,H,W,Dh]
        k_win = (y @ attn.Wk).reshape(B, W, self.n_heads, self.head_dim)
        v_win = (y @ attn.Wv).reshape(B, W, self.n_heads, self.head_dim)
        K, V, row_mask = store.put_get(i, k_win, v_win)
        out = window_attention(q, K, V, row_mask)
        out = out.transpose(1, 2).reshape(B, W, self.d_model)
        if attn.project_out:
            out = out @ attn.Wo + attn.b
        x = h + attn.act(out)
        f = self._layer[f"b{i}_ff2"](
            self._layer[f"b{i}_ff1"](self._layer[f"b{i}_ln2"](x)))
        return x + f

    def supports_head_sharding(self, m: int) -> bool:
        raise NotImplementedError("sharding the paged pools' heads over a "
                                  "mesh is not ported yet (ROADMAP A7b)")


def truncated_draft(net, n_blocks: int = 1):
    """A speculative-decoding draft made by TRUNCATING a
    ``models.transformer_lm`` target: the same embed, positions, final
    norm and head and the first ``n_blocks`` blocks, with the target's
    weights copied by vertex name into a fresh graph on the target's
    device (the draft shares no tensor with the target)."""
    from .zoo_extra import transformer_lm

    spec = TransformerDecodeSpec(net)
    if not 1 <= n_blocks <= spec.n_blocks:
        raise ValueError(f"draft n_blocks must be in 1..{spec.n_blocks}, "
                         f"got {n_blocks}")
    draft = transformer_lm(vocab_size=spec.vocab, d_model=spec.d_model,
                           n_heads=spec.n_heads, n_blocks=n_blocks,
                           max_length=spec.max_length,
                           dtype=str(net.conf.dtype),
                           token_input=spec.token_input,
                           device=net.device).init()
    src = net.param_dicts()
    with torch.no_grad():
        for name, params in draft.param_dicts().items():
            for pname, p in params.items():
                p.copy_(src[name][pname])
    return draft


@torch.inference_mode()
def naive_generate(net, prompt_ids: Sequence[int], max_new: int, *,
                   pad_to: int, spec: Optional[TransformerDecodeSpec] = None,
                   device: DeviceLike = None) -> List[int]:
    """Cache-free greedy reference decode: one full forward (the public
    ``net.output``) per emitted token over prompt + generated-so-far, padded
    to ``pad_to`` (the serving cache capacity, so both paths attend over the
    same padded context). ``device`` (default: the CUDA card) must be the
    net's device."""
    check_same_device("the net", net.device, resolve_device(device))
    spec = spec or TransformerDecodeSpec(net)
    ids = [int(t) for t in prompt_ids]
    if len(ids) + max_new > pad_to:
        raise ValueError(f"prompt ({len(ids)}) + max_new ({max_new}) "
                         f"exceeds pad_to ({pad_to})")
    out: List[int] = []
    for _ in range(max_new):
        buf = np.zeros((1, pad_to), np.int64)
        buf[0, :len(ids)] = ids
        tokens = torch.as_tensor(buf, device=net.device)
        probs = net.output(spec.graph_input(tokens))     # [1, pad_to, V]
        nxt = int(torch.argmax(probs[0, len(ids) - 1]))
        out.append(nxt)
        ids.append(nxt)
    return out


class LSTMDecodeSpec:
    """Incremental decode for a ``text_generation_lstm``-style
    MultiLayerNetwork (LSTM/GravesLSTM stack + RnnOutputLayer head over
    one-hot input): the decode cache is each recurrent layer's (h, c)."""

    def __init__(self, net):
        if not isinstance(net, MultiLayerNetwork):
            raise ValueError("LSTMDecodeSpec supports MultiLayerNetwork "
                             "stacks (ComputationGraph transformers take "
                             "TransformerDecodeSpec)")
        last = net.layers[-1]
        if not isinstance(last, RnnOutputLayer):
            raise ValueError("LSTM decode requires an RnnOutputLayer head")
        if not any(hasattr(l, "apply_with_final_state") for l in net.layers):
            raise ValueError("no recurrent layer found")
        self.net = net
        self.vocab = last.n_out
        self.dtype = net.dtype
        self.token_input = False          # char-LM contract: one-hot input

    def init_states(self, batch: int):
        """Zero (h, c) for ``batch`` sequences per recurrent layer, None for
        the others: the structure ``apply_fn(collect_rnn_states=True)``
        returns."""
        net = self.net
        return [(torch.zeros((batch, l.n_out), dtype=self.dtype,
                             device=net.device),
                 torch.zeros((batch, l.n_out), dtype=self.dtype,
                             device=net.device))
                if hasattr(l, "apply_with_final_state") else None
                for l in net.layers]

    def _head(self, x_seq, rnn_states, mask=None):
        """Run the stack below the head over [B,L,V]; returns its last
        position's logits [B,V] and the new states."""
        net = self.net
        acts, states = net.apply_fn(x_seq, to_layer=len(net.layers) - 2,
                                    features_mask=mask,
                                    rnn_states=rnn_states,
                                    collect_rnn_states=True)
        logits = net.layers[-1].pre_output(acts[-1][:, -1])
        return logits, states

    def _one_hot(self, tokens):
        return F.one_hot(tokens.long(), self.vocab).to(self.dtype)

    @torch.inference_mode()
    def decode_step(self, tokens, rnn_states):
        """tokens [B] int ids -> (pre-activation logits [B,V], new
        states)."""
        return self._head(self._one_hot(tokens[:, None]), rnn_states)

    @torch.inference_mode()
    def prefill_scan(self, tokens, lengths, rnn_states):
        """The padded prompts [B,L] with their lengths [B]: the logits [B,V]
        at position ``length - 1`` and the states after it, what a
        per-token ``rnn_time_step`` priming loop produces."""
        L = tokens.shape[1]
        mask = (torch.arange(L, device=tokens.device)[None, :]
                < lengths[:, None]).to(self.dtype)
        return self._head(self._one_hot(tokens), rnn_states, mask)


@torch.inference_mode()
def naive_generate_lstm(net, prompt_ids: Sequence[int], max_new: int, *,
                        device: DeviceLike = None) -> List[int]:
    """Greedy reference for the char-RNN through the public streaming
    ``rnn_time_step`` (the reference DL4J's own generation story).
    ``device`` (default: the CUDA card) must be the net's device."""
    check_same_device("the net", net.device, resolve_device(device))
    vocab = net.layers[-1].n_out

    def step(tok):
        x = torch.zeros((1, vocab), dtype=net.dtype, device=net.device)
        x[0, int(tok)] = 1.0
        return net.rnn_time_step(x)[0]

    net.rnn_clear_previous_state()
    probs = None
    for t in prompt_ids:
        probs = step(t)
    out: List[int] = []
    for _ in range(max_new):
        nxt = int(torch.argmax(probs))
        out.append(nxt)
        probs = step(nxt)
    return out
