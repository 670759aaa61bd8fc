"""Speculative decoding: a draft proposes k tokens, the target verifies them
in ONE pass.

Counterpart of ``deeplearning4j_tpu/serving/generation/speculative.py``
(``DenseDraftStore`` ``:40``, ``make_dense_draft_cache`` ``:71``, the
draft prefills ``:81-108``, ``propose_dense_fn`` ``:111``,
``propose_state_fn`` ``:136``, ``rewind_state_fn`` ``:156``,
``verify_fn`` ``:174``, ``accept_greedy`` ``:190``). The reference's
program builders return functions that are lowered once; here they are
plain functions on tensors, run eagerly by ``GenerationProgramSet``, and
every cache is updated in place.

A cheap DRAFT proposes ``k`` greedy continuations per slot, the target
runs one batched VERIFY window over ``[cur, p_1..p_k]``
(``TransformerDecodeSpec.decode_window`` + ``PagedWindowStore``), and the
scheduler accepts the longest prefix where the draft agreed with the
target's own greedy choice plus the target's correction token at the
first disagreement. Every accepted token is the token plain greedy decode
gives, so speculation changes the schedule, never the tokens.

Two draft adapters:

- ``dense`` — a (truncated) transformer draft with a dense per-slot K/V
  cache ``[layers, slots+1, capacity, H, Dh]``: rejected proposals' K/V
  are overwritten before any later mask can see them, so rollback is not
  advancing ``pos``.
- ``state`` — an LSTM draft whose cache is its recurrent state. It cannot
  un-consume a token, so propose stacks the state after EVERY fed token
  and rewind gathers, per slot, the state matching what verify accepted.
  Each propose step is one K5 launch per LSTM layer (T 1).

Head-sharded (a target or dense draft spec with ``model_shards`` m > 1,
``models/decode.py``), every cache has its heads split over m rows,
rank-major, and each pass takes one store a rank over its row.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .kvcache import rank_stores


class DenseDraftStore:
    """``models.decode.KVStore`` over the draft's dense per-slot cache for
    one propose step: row ``s`` writes position ``pos[s]``; idle slots (and
    positions past capacity) write the trash row."""

    def __init__(self, k_cache, v_cache, pos, active):
        # k_cache/v_cache: [Ld, S+1, cap, H, Dh]; row S is trash
        self.k_cache = k_cache
        self.v_cache = v_cache
        S = pos.shape[0]
        cap = k_cache.shape[2]
        pos = pos.long()
        ok = active & (pos < cap)
        rows = torch.arange(S, device=pos.device)
        self._row = torch.where(ok, rows, torch.full_like(rows, S))
        self._off = torch.where(ok, pos, torch.zeros_like(pos))
        self._mask = (torch.arange(cap, device=pos.device)[None, :]
                      <= pos[:, None])

    def put_get(self, i: int, k_tok, v_tok):
        self.k_cache[i].index_put_((self._row, self._off), k_tok)
        self.v_cache[i].index_put_((self._row, self._off), v_tok)
        S = k_tok.shape[0]
        K = self.k_cache[i, :S].transpose(1, 2)          # [S,H,cap,Dh]
        V = self.v_cache[i, :S].transpose(1, 2)
        return K, V, self._mask


def make_dense_draft_cache(draft_spec, slots: int, capacity: int,
                           device: torch.device):
    """Zero-filled (k_cache, v_cache) for the dense draft adapter
    (``[m, layers, slots+1, cap, H/m, Dh]`` head-sharded)."""
    m = draft_spec.model_shards
    shape = (draft_spec.n_blocks, slots + 1, capacity,
             draft_spec.n_heads // m, draft_spec.head_dim)
    if m > 1:
        shape = (m,) + shape
    return (torch.zeros(shape, dtype=draft_spec.dtype, device=device),
            torch.zeros(shape, dtype=draft_spec.dtype, device=device))


@torch.inference_mode()
def draft_prefill_dense(draft_spec, cache, tokens, slots) -> None:
    """The dense draft's full-prompt prefill [P,L]: each row's K/V lands
    in its slot's row of the cache (padding rows in the trash row)."""
    kc, vc = cache
    _, ks, vs = draft_spec.prefill_forward(tokens)
    L = tokens.shape[1]
    slots = slots.long()
    for i in range(draft_spec.n_blocks):
        kc[..., i, slots, :L, :, :] = ks[i]
        vc[..., i, slots, :L, :, :] = vs[i]


@torch.inference_mode()
def draft_prefill_state(draft_spec, states_all, tokens, lengths,
                        slots) -> None:
    """The LSTM draft's masked prefill: each row's final state lands at its
    slot (padding rows at the trash row)."""
    P = tokens.shape[0]
    _, final = draft_spec.prefill_scan(tokens, lengths,
                                       draft_spec.init_states(P))
    slots = slots.long()
    for carry, new in zip(states_all, final):
        if carry is not None:
            carry[0][slots] = new[0]
            carry[1][slots] = new[1]


@torch.inference_mode()
def propose_dense(draft_spec, cache, k: int, cur, pos, active):
    """Greedy chain over the dense draft: feed cur at pos -> p_1, feed p_1
    -> p_2, ... It runs k+1 feeds (through p_k, whose K/V lands at pos+k)
    so a fully accepted window leaves NO unwritten gap behind the next
    round's base position. Returns the proposals [S,k]."""
    kc, vc = cache
    tok, p = cur, pos.long()
    toks = []
    for _ in range(k + 1):
        store = rank_stores(draft_spec.model_shards,
                            lambda k, v: DenseDraftStore(k, v, p, active),
                            kc, vc)
        logits = draft_spec.decode_step(tok, p, store)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        p = p + 1
    return torch.stack(toks[:k], dim=1)


@torch.inference_mode()
def propose_state(draft_spec, states_all, k: int, cur):
    """k+1 LSTM steps from each slot's state (cur, p_1..p_k) -> (proposals
    [S,k], stack): stack[j] is every layer's state after the (j+1)-th fed
    token, [k+1] entries covering every possible rewind target."""
    S = cur.shape[0]
    st = [None if c is None else (c[0][:S], c[1][:S]) for c in states_all]
    tok, toks, stack = cur, [], []
    for _ in range(k + 1):
        logits, st = draft_spec.decode_step(tok, st)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        stack.append(st)
    return torch.stack(toks[:k], dim=1), stack


@torch.inference_mode()
def rewind_state(states_all, stack, idx, mask) -> None:
    """Per slot, commit the stacked draft state matching what verify
    accepted: ``idx`` [S] in 1..k+1 picks stack[idx-1]; slots off ``mask``
    (finished, sampling, idle) keep their state."""
    S = idx.shape[0]
    rows = torch.arange(S, device=idx.device)
    keep = mask[:, None]
    for layer, carry in enumerate(states_all):
        if carry is None:
            continue
        for j in (0, 1):
            sel = torch.stack([st[layer][j] for st in stack])[idx.long() - 1,
                                                               rows]
            carry[j][:S] = torch.where(keep, sel, carry[j][:S])


@torch.inference_mode()
def verify(target_spec, cache, block_len: int, k: int, feeds, pos, tables,
           active):
    """One batched target pass over the verify window [S,k+1] -> the greedy
    targets [S,k+1]; row i's argmax is what one-token decode at pos+i
    gives."""
    from .kvcache import PagedWindowStore
    store = rank_stores(target_spec.model_shards,
                        lambda kp, vp: PagedWindowStore(kp, vp, tables, pos,
                                                        active, block_len,
                                                        k + 1),
                        cache[0], cache[1])
    logits = target_spec.decode_window(feeds, pos, store)
    return torch.argmax(logits, dim=-1)


def accept_greedy(proposals: np.ndarray,
                  targets: np.ndarray) -> Tuple[np.ndarray, List[List[int]]]:
    """The exact-output acceptance rule. ``proposals`` [S,k] (draft),
    ``targets`` [S,k+1] (target greedy per window row). Returns
    (accepted_counts [S], emitted token lists): slot s emits its accepted
    proposals plus the target's correction token at the first disagreement
    — 1..k+1 tokens, each identical to what plain greedy decode emits."""
    S, k = proposals.shape
    agree = proposals == targets[:, :k]
    counts = np.where(agree.all(axis=1), k,
                      np.argmin(agree, axis=1)).astype(np.int64)
    emitted = [list(proposals[s, :counts[s]]) + [int(targets[s, counts[s]])]
               for s in range(S)]
    return counts, emitted
