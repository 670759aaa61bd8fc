"""Cache-aware autoregressive decode for the transformer LM.

Counterpart of ``deeplearning4j_tpu/models/decode.py``:
``TransformerDecodeSpec`` (``prefill_forward`` ``:167``, ``decode_step``
``:194``, ``_block_step`` ``:214``) and ``naive_generate`` (``:399``).

- ``prefill_forward`` runs the graph's own ``apply_fn`` over the padded
  prompt, so its logits are those of a plain ``net.output`` (and its
  attention takes the flash-attention kernel where the probe admits the
  shapes), and returns each block's K/V for the paged cache.
- ``decode_step`` feeds one token per sequence through a K/V store (the
  paged ``serving.generation.kvcache.PagedStore``) and replays each layer's
  own math position by position; its attention row is the plain
  ``parallel.ring_attention.attention`` over the gathered context.
- ``naive_generate`` is the cache-free greedy reference: one full forward
  per emitted token.

The speculative-decoding window, the LSTM spec and the draft builder come
with later slices.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, check_same_device, resolve_device
from ..nn.layers import (DenseLayer, EmbeddingSequenceLayer,
                         LayerNormalization, RnnOutputLayer,
                         SelfAttentionLayer)
from ..parallel.ring_attention import attention


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
