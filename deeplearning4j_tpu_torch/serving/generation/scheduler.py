"""Continuous batching: slot-based decode scheduling with step-boundary
admission, per-token streams, the prefix cache, speculative decoding and
cohort-pinned hot swap.

Counterpart of ``deeplearning4j_tpu/serving/generation/scheduler.py``
(``TokenStream`` with ``cancel``, ``_Cohort`` ``:146``, ``ModelRuntime``:
``queue_depth`` / ``in_flight`` / ``draining`` / ``steering``, ``submit``,
``_loop``, ``_cohort_for_admission``, ``_worth_replaying``,
``_setup_blocks``, ``_admit``, ``_prefill_misses``, ``_admit_hits``,
``_draft_prefill``, ``_step``, ``_plain_step``, ``_replay_advance``,
``_spec_step``, ``_check_quiesce``, ``_slot_emit``, ``_finish_slot``,
``_fail_all``, ``stop``). One dispatch thread per model owns the loop:

    loop:  admit (bucketed prefill of queued misses, prefix hits that
           replay their unmatched suffix, the draft's prefill)
           -> one decode step per live cohort (ALL in-flight sequences
              advance one token; speculating slots advance through a
              draft proposal and one verify window instead)
           -> emit tokens to per-request TokenStreams, retire finished
              slots (stop token / max_tokens / deadline / cancel), which
              frees or releases their cache blocks for the next admission

Hot-swap cutover rule: a request is pinned to the program set it was
admitted under. After ``hot_swap``, new admissions form a NEW cohort on
the new set (its own pool, prefix cache, draft cache and, on the card,
decode graph); old cohorts keep decoding on the old weights until they
drain, then their pool and graph are released.

On the card each cohort's decode step runs as a CUDA graph captured on
this thread when the cohort is made (``graphs.DecodeGraph``): the first
cohort before the runtime takes traffic, a swapped-in set's at the loop's
next turn. Prefill, the block copy and the draft and verify passes run
eagerly on this thread's current stream. The host side is numpy. The
reference's telemetry spans, trace events and flight recorder are
ROADMAP A8.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..errors import (BlockPoolExhaustedError, DeadlineExceededError,
                      DrainingError, GenerationClosedError, QueueFullError,
                      ShapeMismatchError)
from .kvcache import BlockAllocator
from .metrics import GenerationMetrics
from .prefix import PrefixCache
from .programs import GenerationProgramSet


class TokenStream:
    """Per-request token stream: the scheduler produces, ONE consumer
    iterates (or calls ``result()`` — not both). Every admitted request is
    finished with a reason (or failed) exactly once, so iterating callers
    never hang."""

    def __init__(self):
        self._q: "_queue.Queue" = _queue.Queue()
        self._done = threading.Event()
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.emitted = 0
        self._cancel_cb = None

    # ---------------------------------------------------- producer (loop)
    def _put(self, tok: int) -> None:
        self.emitted += 1
        self._q.put(("tok", tok))

    def _finish(self, reason: str, error: Optional[BaseException] = None):
        if self._done.is_set():
            return
        self.finish_reason = reason
        self.error = error
        self._done.set()
        self._q.put(("end", reason))

    # ------------------------------------------------------------ consumer
    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == "tok":
                yield val
            else:
                return

    def result(self, raise_on_error: bool = True):
        """Drain the stream; returns (tokens, finish_reason). A stream that
        failed raises (unless ``raise_on_error`` is False)."""
        tokens = list(self)
        if raise_on_error and self.error is not None \
                and self.finish_reason not in ("deadline",):
            raise self.error
        return tokens, self.finish_reason

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """The consumer gave up (e.g. its client disconnected): the
        scheduler retires the slot at the next step boundary."""
        if self._cancel_cb is not None:
            self._cancel_cb()


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "top_k", "stop",
                 "deadline", "stream", "slot", "blocks", "shared_blocks",
                 "replay", "replaying", "matched_tokens", "spec", "emitted",
                 "cancelled", "cancel_reason", "enqueue_t", "cohort")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 top_k: int, stop: frozenset, deadline: float,
                 speculative: bool = True):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.stop = stop
        self.deadline = deadline
        self.stream = TokenStream()
        self.stream._cancel_cb = self._cancel
        self.slot: Optional[int] = None
        self.blocks: List[int] = []          # owned (freed at finish)
        self.shared_blocks: List[int] = []   # cache custody (released)
        self.replay: "deque[int]" = deque()  # prompt suffix still to feed
        self.replaying = False
        self.matched_tokens = 0
        # speculative decoding is exact only for greedy requests; sampling
        # ones ride the plain decode step
        self.spec = bool(speculative) and temperature <= 0.0
        self.cohort = None                  # set at admission
        self.emitted = 0
        self.cancelled = False
        self.cancel_reason = "cancelled"
        self.enqueue_t = time.monotonic()

    def _cancel(self):
        self.cancelled = True


class _Cohort:
    """In-flight sequences pinned to one program set (one model version):
    their cache pool, block allocator, block tables, prefix cache, draft
    cache and decode graph live and die with the cohort — shared prefix
    K/V and draft proposals never cross a hot-swap boundary."""
    __slots__ = ("ps", "cache", "allocator", "tables", "slots", "version",
                 "prefix", "draft_cache", "gen", "graph")

    def __init__(self, ps: GenerationProgramSet, version: int, gen):
        self.ps = ps
        self.version = version
        self.cache = ps.make_cache()
        self.allocator = BlockAllocator(ps.config.num_blocks)
        S, mb = ps.config.decode_slots, ps.config.blocks_per_seq
        self.tables = np.zeros((S, mb), np.int64)
        self.slots: Set[int] = set()
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.allocator, ps.config.block_len)
            if ps.prefix_enabled else None)
        self.draft_cache = ps.make_draft_cache()
        self.gen = gen
        self.graph = None
        if ps.device.type == "cuda":
            from .graphs import DecodeGraph
            self.graph = DecodeGraph(ps, self.cache, gen)

    def decode(self, tokens, pos, mask, temp, topk) -> np.ndarray:
        """One decode step over this cohort's pool: its CUDA graph on the
        card, the eager step on the CPU."""
        if self.graph is not None:
            return self.graph.run(tokens, pos, self.tables, mask, temp, topk)
        return self.ps.run_decode(self.cache, tokens, pos, self.tables, mask,
                                  self.gen, temp, topk)

    def release(self) -> None:
        if self.graph is not None:
            self.graph.release()
            self.graph = None


class ModelRuntime:
    """Scheduler + device state for one generation model."""

    def __init__(self, name: str, ps: GenerationProgramSet,
                 metrics: Optional[GenerationMetrics] = None):
        self.name = name
        self.active_ps = ps
        self.version = 1
        self.swap_lock = threading.Lock()
        self.config = ps.config
        self.metrics = metrics or GenerationMetrics(name=name)
        self.metrics.set_kv_bytes_per_token(ps.kv_bytes_per_token())
        S = self.config.decode_slots
        self._queue: "deque[_GenRequest]" = deque()
        self._cond = threading.Condition()
        self._slots_free: Set[int] = set(range(S))
        self._slot_req: Dict[int, _GenRequest] = {}
        self._tokens = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._active = np.zeros(S, np.bool_)
        self._cohorts: List[_Cohort] = []
        self._gen = ps.fresh_generator()
        self._draining = False
        self._stopped = False
        # warm runs seen while the loop serves (the engine pauses this
        # around warm-up, as the reference pauses its recompile detector)
        self.watching = True
        self.warm_runs_while_serving = 0
        self.cohorts_made = 0
        # replays and kernel runs of the decode graphs of retired cohorts
        self._retired = {"replays": 0, "kernel_runs": Counter()}
        self._idle = threading.Event()
        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"generation-{name}")
        self._thread.start()
        self._ready.wait()
        if self._start_error is not None:
            self._thread.join(timeout=5.0)
            raise self._start_error

    # ----------------------------------------------------------- observability
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return len(self._slot_req)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def cohorts(self) -> List[_Cohort]:
        return list(self._cohorts)

    def graph_stats(self) -> dict:
        """This runtime's decode graphs: how many were captured, their
        replays, and per kernel the launches those replays made (a
        replay's launches are the ones its capture enqueued; the wrappers'
        own counts see none of them)."""
        replays = self._retired["replays"]
        runs = Counter(self._retired["kernel_runs"])
        for c in self._cohorts:
            if c.graph is not None:
                replays += c.graph.replays
                for name, n in c.graph.launches.items():
                    runs[name] += n * c.graph.replays
        return {"captures": (self.cohorts_made
                             if self.active_ps.device.type == "cuda" else 0),
                "replays": replays, "kernel_runs": dict(runs)}

    def _retire(self, coh: _Cohort) -> None:
        g = coh.graph
        if g is not None:
            self._retired["replays"] += g.replays
            for name, n in g.launches.items():
                self._retired["kernel_runs"][name] += n * g.replays
        coh.release()

    def steering(self) -> dict:
        """Cheap routing signals for a fleet router: prefix hit rate,
        decode-slot occupancy, block-pool free fraction and queue depth,
        plus the ``block_len`` an affinity hash needs. Lock-free reads of
        ints; a torn snapshot mis-routes one request at worst."""
        cfg = self.config
        cohorts = self._cohorts
        coh = cohorts[-1] if cohorts else None
        free = coh.allocator.free_blocks if coh is not None \
            else cfg.num_blocks
        m = self.metrics
        lookups = m.prefix_hits + m.prefix_misses
        in_flight = len(self._slot_req)
        return {
            "queue_depth": len(self._queue),
            "in_flight": in_flight,
            "decode_slots": cfg.decode_slots,
            "slot_occupancy": round(in_flight / cfg.decode_slots, 4),
            "block_len": cfg.block_len,
            "blocks_total": cfg.num_blocks,
            "block_pool_free_frac": (round(free / cfg.num_blocks, 4)
                                     if cfg.num_blocks else 1.0),
            "prefix_hit_rate": (round(m.prefix_hits / lookups, 4)
                                if lookups else 0.0),
            "prefix_lookups": lookups,
        }

    # -------------------------------------------------------------- admission
    def submit(self, prompt, *, max_new: int, temperature: float = 0.0,
               top_k: int = 0, stop: Sequence[int] = (),
               timeout: Optional[float] = None,
               speculative: bool = True) -> TokenStream:
        cfg = self.config
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 1:
            raise ShapeMismatchError("empty prompt")
        if max_new < 1:
            raise ShapeMismatchError(f"max_tokens must be >= 1, "
                                     f"got {max_new}")
        if plen > cfg.max_prompt_len:
            raise ShapeMismatchError(
                f"prompt length {plen} exceeds the largest prompt rung "
                f"{cfg.max_prompt_len}")
        if plen + max_new > cfg.capacity:
            raise ShapeMismatchError(
                f"prompt ({plen}) + max_tokens ({max_new}) exceeds cache "
                f"capacity {cfg.capacity} tokens")
        if self.active_ps.adapter == "paged":
            need = cfg.blocks_needed(plen, max_new)
            if need > cfg.num_blocks - 1:
                raise BlockPoolExhaustedError(
                    f"request needs {need} cache blocks but the pool only "
                    f"has {cfg.num_blocks - 1} — lower max_tokens or grow "
                    f"num_blocks; retry will not help at this size",
                    retryable=False)
        timeout = cfg.default_timeout_s if timeout is None else timeout
        req = _GenRequest(prompt, int(max_new), float(temperature),
                          int(top_k), frozenset(int(s) for s in stop),
                          time.monotonic() + timeout,
                          speculative=speculative)
        with self._cond:
            if self._draining or self._stopped:
                self.metrics.record_rejection("draining")
                raise DrainingError(
                    f"generation model '{self.name}' is draining/stopped")
            if len(self._queue) >= cfg.queue_limit:
                cohorts = self._cohorts       # the loop rebinds the list
                coh = cohorts[-1] if cohorts else None
                if self.active_ps.adapter == "paged" and coh is not None \
                        and coh.allocator.free_blocks == 0 \
                        and (coh.prefix is None
                             or coh.prefix.lru_blocks == 0):
                    self.metrics.record_rejection("exhausted")
                    raise BlockPoolExhaustedError(
                        f"model '{self.name}': KV block pool exhausted and "
                        f"admission queue full ({cfg.queue_limit}) — retry "
                        f"after in-flight generations complete")
                self.metrics.record_rejection("full")
                raise QueueFullError(
                    f"model '{self.name}' generation queue full "
                    f"({cfg.queue_limit} requests)")
            self.metrics.record_request()
            self._idle.clear()
            self._queue.append(req)
            self._cond.notify_all()
        return req.stream

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Wait until the loop has finished all submitted work, the step
        that retired the last request included (its metrics recorded, a
        drained cohort released). Returns False on timeout."""
        return self._idle.wait(timeout)

    # ------------------------------------------------------------ loop body
    def _loop(self):
        try:
            try:
                self._cohort_for_admission()   # the first graph, pre-traffic
            except Exception as e:
                self._start_error = e
                self._stopped = True
                return
            finally:
                self._ready.set()
            while True:
                with self._cond:
                    if self._stopped:
                        break
                    if not self._queue and not self._slot_req:
                        self._idle.set()
                        self._cond.wait(0.02)
                        continue
                try:
                    # a swapped-in set's cohort (and graph) before admission
                    self._cohort_for_admission()
                    self._admit()
                    self._step()
                except Exception as e:       # nobody may hang on a failure
                    self._fail_all(e)
        finally:
            self._shutdown_flush()

    def _cohort_for_admission(self) -> _Cohort:
        ps = self.active_ps
        if self._cohorts and self._cohorts[-1].ps is ps:
            return self._cohorts[-1]
        coh = _Cohort(ps, self.version, self._gen)
        self.cohorts_made += 1
        self._cohorts = self._cohorts + [coh]
        return coh

    def _worth_replaying(self, matched_blocks: int, plen: int) -> bool:
        """A cache hit replays its unmatched suffix ONE token per decode
        step, far slower than a batched prefill for a long suffix: take the
        hit only when the suffix fits ``prefix_max_replay`` (default 2
        blocks); a shorter match admits as a miss (and still registers its
        blocks)."""
        if not matched_blocks:
            return False
        suffix = plen - matched_blocks * self.config.block_len
        if suffix == 0:
            suffix = 1                    # block-aligned: COW + one feed
        return suffix <= self.config.prefix_max_replay

    def _setup_blocks(self, coh: _Cohort, r: _GenRequest) -> None:
        """Blocks for one admission (paged adapter, under the cond lock):
        take references on the longest cached prefix, evict refcount-0 LRU
        blocks if the fresh remainder needs room, allocate the rest.
        ``r.matched_tokens == len(prompt)`` flags the block-aligned full
        match whose COW copy the caller performs after the lock."""
        cfg = self.config
        total = cfg.blocks_needed(len(r.prompt), r.max_new)
        plen = len(r.prompt)
        if coh.prefix is None or not self._worth_replaying(
                coh.prefix.probe(r.prompt), plen):
            # miss (or a match too short to beat prefill): the plain path,
            # still evicting refcount-0 LRU blocks under pool pressure
            if coh.prefix is not None:
                evicted = coh.prefix.ensure_free(total)
                if evicted:
                    self.metrics.record_prefix_evictions(evicted)
            r.blocks = coh.allocator.alloc(total) if total else []
            return
        shared, matched = coh.prefix.match(r.prompt)
        # the final prompt token must still be FED through decode for its
        # next-token logits; when the match covers the whole prompt that
        # feed writes inside the last shared block -> COW copy needed
        fresh = total - len(shared) + (1 if matched == plen and shared
                                       else 0)
        evicted = coh.prefix.ensure_free(fresh)
        if evicted:
            self.metrics.record_prefix_evictions(evicted)
        r.blocks = coh.allocator.alloc(fresh) if fresh else []
        r.shared_blocks = shared
        r.matched_tokens = matched

    def _admit(self):
        cfg = self.config
        cands: List[_GenRequest] = []
        now = time.monotonic()
        with self._cond:
            # expire or cancel while queued
            keep: "deque[_GenRequest]" = deque()
            while self._queue:
                r = self._queue.popleft()
                if r.cancelled:
                    r.stream._finish(r.cancel_reason)
                    self.metrics.record_finish(r.cancel_reason)
                elif now > r.deadline:
                    self.metrics.record_rejection("deadline")
                    r.stream._finish("deadline", DeadlineExceededError(
                        "deadline expired while queued for admission"))
                else:
                    keep.append(r)
            self._queue = keep
            if not self._queue or not self._slots_free:
                return
            coh = self._cohort_for_admission()
            max_p = cfg.prefill_batches[-1]
            blk = cfg.block_len
            while self._queue and self._slots_free and len(cands) < max_p:
                r = self._queue[0]
                if coh.ps.adapter != "state":
                    total = cfg.blocks_needed(len(r.prompt), r.max_new)
                    budget = coh.allocator.free_blocks
                    fresh = total
                    if coh.prefix is not None:
                        m = coh.prefix.probe(r.prompt)
                        if not self._worth_replaying(m, len(r.prompt)):
                            m = 0                # short match -> plain miss
                        fresh = total - m + \
                            (1 if m and m * blk == len(r.prompt) else 0)
                        budget += coh.prefix.evictable_for(r.prompt)
                    if fresh > budget:
                        break        # head-of-line: wait for blocks to free
                self._queue.popleft()
                # registered for failure delivery BEFORE block setup, so a
                # failure there resolves this caller through _fail_all
                r.slot = self._slots_free.pop()
                r.cohort = coh
                self._slot_req[r.slot] = r
                if coh.ps.adapter != "state":
                    self._setup_blocks(coh, r)
                cands.append(r)
        if not cands:
            return
        hits = [r for r in cands if r.matched_tokens]
        misses = [r for r in cands if not r.matched_tokens]
        if misses:
            self._prefill_misses(coh, misses)
        if hits:
            self._admit_hits(coh, hits)
        if coh.ps.spec_k:
            # speculating requests only: sampling or opted-out rows would
            # waste draft work and could force a larger (P, L) rung
            spec_cands = [r for r in cands if r.spec]
            if spec_cands:
                self._draft_prefill(coh, spec_cands)
        if coh.prefix is not None:
            self.metrics.set_prefix_gauges(coh.prefix.stats())

    def _prefill_misses(self, coh: _Cohort, cands: List[_GenRequest]):
        cfg = self.config
        S, mb = cfg.decode_slots, cfg.blocks_per_seq
        P = cfg.prefill_rung(len(cands))
        L = cfg.prompt_rung(max(len(r.prompt) for r in cands))
        tokens = np.zeros((P, L), np.int64)
        lengths = np.ones(P, np.int64)
        tables_p = np.zeros((P, mb), np.int64)      # padding rows -> trash
        slots = np.full(P, S, np.int64)             # ... and trash slot
        temp = np.zeros(P, np.float32)
        topk = np.zeros(P, np.int64)
        for i, r in enumerate(cands):
            plen = len(r.prompt)
            tokens[i, :plen] = r.prompt
            lengths[i] = plen
            tables_p[i, :len(r.blocks)] = r.blocks
            slots[i] = r.slot
            temp[i] = r.temperature
            topk[i] = r.top_k
        first = coh.ps.run_prefill(coh.cache, tokens, lengths, tables_p,
                                   slots, self._gen, temp, topk)
        now = time.monotonic()
        emitted = 0
        for i, r in enumerate(cands):
            s = r.slot
            coh.slots.add(s)
            coh.tables[s] = tables_p[i]
            self._pos[s] = len(r.prompt)
            self._temp[s] = r.temperature
            self._topk[s] = r.top_k
            if coh.prefix is not None:
                self.metrics.record_prefix_miss()
                # the prompt's full blocks are immutable from here on:
                # index them so the next identical prefix skips this
                # prefill; custody of registered blocks moves to the cache
                managed = coh.prefix.register(r.prompt, tables_p[i],
                                              r.blocks)
                if managed:
                    drop = set(managed)
                    r.blocks = [b for b in r.blocks if b not in drop]
                    r.shared_blocks.extend(managed)
            did_emit, _ = self._slot_emit(coh, r, int(first[i]), now)
            emitted += did_emit
        self.metrics.record_prefill(
            len(cands), [(now - r.enqueue_t) * 1e3 for r in cands], emitted)

    def _admit_hits(self, coh: _Cohort, hits: List[_GenRequest]):
        """Cache-hit admission: NO target prefill. The sequence's table
        points at the shared read-only blocks; the unmatched prompt suffix
        replays through the decode step (one token a step, teacher-forced),
        and the first emitted token falls out of the step that feeds the
        final prompt token. A block-aligned full match copies the last
        shared block first (COW): its final position is rewritten by that
        feed, and shared blocks are never written."""
        for r in hits:
            s = r.slot
            plen = len(r.prompt)
            if r.matched_tokens == plen:
                src = r.shared_blocks[-1]
                dst = r.blocks[0]
                coh.ps.run_cow(coh.cache, src, dst)
                coh.prefix.release([src])
                r.shared_blocks = r.shared_blocks[:-1]
                coh.prefix.cow_copies += 1
                self.metrics.record_cow()
                table = r.shared_blocks + [dst] + r.blocks[1:]
                start = plen - 1
            else:
                table = r.shared_blocks + r.blocks
                start = r.matched_tokens
            row = np.zeros(self.config.blocks_per_seq, np.int64)
            row[:len(table)] = table
            coh.slots.add(s)
            coh.tables[s] = row
            self._pos[s] = start
            self._temp[s] = r.temperature
            self._topk[s] = r.top_k
            self._tokens[s] = int(r.prompt[start])
            self._active[s] = True
            r.replay = deque(int(t) for t in r.prompt[start + 1:])
            r.replaying = True
            self.metrics.record_prefix_hit(start)

    def _draft_prefill(self, coh: _Cohort, cands: List[_GenRequest]):
        """The draft consumes every admitted FULL prompt (hits included —
        the target skipped its matched span; the draft has no paged cache
        to share)."""
        cfg = self.config
        S = cfg.decode_slots
        P = cfg.prefill_rung(len(cands))
        L = cfg.prompt_rung(max(len(r.prompt) for r in cands))
        tokens = np.zeros((P, L), np.int64)
        lengths = np.ones(P, np.int64)
        slots = np.full(P, S, np.int64)
        for i, r in enumerate(cands):
            plen = len(r.prompt)
            tokens[i, :plen] = r.prompt
            lengths[i] = plen
            slots[i] = r.slot
        coh.ps.run_draft_prefill(coh.draft_cache, tokens, lengths, slots)

    def _step(self):
        for coh in list(self._cohorts):
            live = [s for s in sorted(coh.slots) if self._active[s]]
            if not live:
                continue
            # speculative slots (greedy, past replay) advance through a
            # draft proposal + one batched verify; everything else — spec
            # off, sampling requests, prompt-suffix replay — rides the
            # plain one-token decode step
            spec_on = coh.ps.spec_k > 0
            plain = [s for s in live
                     if not spec_on or not self._slot_req[s].spec
                     or self._slot_req[s].replaying]
            specs = [s for s in live if s not in set(plain)]
            if plain:
                self._plain_step(coh, plain)
            if specs:
                self._spec_step(coh, specs)
        self.metrics.record_recompile(self.warm_runs_while_serving)
        # drop drained cohorts (old weights, pools and graphs released)
        keep = [c for c in self._cohorts
                if c.slots or c.ps is self.active_ps]
        for c in self._cohorts:
            if c not in keep:
                self._retire(c)
        self._cohorts = keep
        if not self._slot_req:
            self._check_quiesce()

    def _plain_step(self, coh: _Cohort, live: List[int]):
        S = self.config.decode_slots
        mask = np.zeros(S, np.bool_)
        mask[live] = True
        t0 = time.perf_counter()
        nxt = coh.decode(self._tokens, self._pos, mask, self._temp,
                         self._topk)
        dt_ms = (time.perf_counter() - t0) * 1e3
        now = time.monotonic()
        emitted = 0
        for s in live:
            r = self._slot_req[s]
            if r.replaying:
                emitted += self._replay_advance(coh, r, int(nxt[s]), now)
                continue
            did_emit, cont = self._slot_emit(coh, r, int(nxt[s]), now)
            emitted += did_emit
            if cont:
                self._pos[s] += 1
        self.metrics.record_decode_step(
            dt_ms, len(live), emitted, slots=S,
            blocks_used=coh.allocator.used_blocks,
            blocks_total=coh.allocator.total_usable,
            queue_depth=len(self._queue))

    def _replay_advance(self, coh: _Cohort, r: _GenRequest, sampled: int,
                        now: float) -> int:
        """One replay step of a cache-hit admission: the decode step just
        fed prompt[pos]. While suffix tokens remain the sample is a
        mid-prompt prediction — discarded; teacher-force the next prompt
        token. The step that fed the FINAL prompt token gave the first
        generated token: record the cached TTFT and emit. Returns tokens
        emitted (0 or 1)."""
        s = r.slot
        if r.cancelled or now > r.deadline:
            if r.cancelled:
                err = GenerationClosedError("engine stopped mid-generation") \
                    if r.cancel_reason == "shutdown" else None
                self._finish_slot(coh, r, r.cancel_reason, err)
            else:
                self._finish_slot(coh, r, "deadline", DeadlineExceededError(
                    "deadline expired while replaying the prompt suffix"))
            return 0
        if r.replay:
            self._tokens[s] = r.replay.popleft()
            self._pos[s] += 1
            return 0
        r.replaying = False
        self.metrics.record_cached_first_token((now - r.enqueue_t) * 1e3)
        if coh.prefix is not None:
            # full prompt blocks beyond the matched span are now valid:
            # index them so the NEXT request extends the cached chain
            managed = coh.prefix.register(r.prompt, coh.tables[s], r.blocks)
            if managed:
                drop = set(managed)
                r.blocks = [b for b in r.blocks if b not in drop]
                r.shared_blocks.extend(managed)
            self.metrics.set_prefix_gauges(coh.prefix.stats())
        did_emit, cont = self._slot_emit(coh, r, sampled, now)
        if cont:
            self._pos[s] += 1
        return did_emit

    def _spec_step(self, coh: _Cohort, specs: List[int]):
        """The draft proposes k tokens per slot; ONE batched target pass
        verifies; the longest agreeing prefix + the target's correction
        token are emitted — plain-greedy output, up to k+1 tokens per
        target dispatch."""
        from .speculative import accept_greedy
        S, k = self.config.decode_slots, coh.ps.spec_k
        mask = np.zeros(S, np.bool_)
        mask[specs] = True
        t0 = time.perf_counter()
        props, stack = coh.ps.run_propose(coh.draft_cache, self._tokens,
                                          self._pos, mask)
        feeds = np.concatenate([self._tokens[:, None], props], axis=1)
        targets = coh.ps.run_verify(coh.cache, feeds, self._pos, coh.tables,
                                    mask)
        dt_ms = (time.perf_counter() - t0) * 1e3
        counts, emitted_toks = accept_greedy(props, targets)
        now = time.monotonic()
        emitted = 0
        accepted = 0
        cont_mask = np.zeros(S, np.bool_)
        rewind_idx = np.ones(S, np.int64)
        for s in specs:
            r = self._slot_req[s]
            accepted += int(counts[s])
            n_emit, cont = 0, False
            for tok in emitted_toks[s]:
                did, cont = self._slot_emit(coh, r, int(tok), now)
                n_emit += did
                if not cont:
                    break
            emitted += n_emit
            if cont:
                self._pos[s] += n_emit
                cont_mask[s] = True
                rewind_idx[s] = n_emit
        if coh.ps.draft_adapter == "state":
            # commit, per continuing slot, the draft state matching what
            # verify accepted (s_{j+1} = after the j-th accepted proposal)
            coh.ps.run_rewind(coh.draft_cache, stack, rewind_idx, cont_mask)
        self.metrics.record_verify(
            dt_ms, len(specs), proposed=k * len(specs), accepted=accepted,
            emitted=emitted, slots=S,
            blocks_used=coh.allocator.used_blocks,
            blocks_total=coh.allocator.total_usable,
            queue_depth=len(self._queue))

    def _check_quiesce(self):
        """Block-accounting invariant with no request in flight: every
        allocated block is exactly a cached block. A violation is a leak or
        a double-custody bug and fails loudly (the loop turns it into
        _fail_all) rather than serving corrupt shared state."""
        for coh in self._cohorts:
            if coh.ps.adapter != "paged" or coh.slots:
                continue
            alloc = set(coh.allocator.allocated)
            cached = (coh.prefix.cached_block_ids()
                      if coh.prefix is not None else set())
            if alloc != cached:
                raise RuntimeError(
                    f"block accounting violated at quiesce for model "
                    f"'{self.name}': leaked={sorted(alloc - cached)} "
                    f"phantom={sorted(cached - alloc)}")

    def _slot_emit(self, coh: _Cohort, r: _GenRequest, tok: int,
                   now: float):
        """Handle one sampled token for a slot: emit or terminate. Returns
        (emitted, continuing)."""
        if r.cancelled:
            # a shutdown surfaces as an ERROR to blocking callers; a
            # consumer's cancel is a normal close
            err = GenerationClosedError("engine stopped mid-generation") \
                if r.cancel_reason == "shutdown" else None
            return self._finish_slot(coh, r, r.cancel_reason, err)
        if now > r.deadline:
            return self._finish_slot(
                coh, r, "deadline",
                DeadlineExceededError("deadline expired mid-generation "
                                      f"after {r.emitted} tokens"))
        if tok in r.stop:
            return self._finish_slot(coh, r, "stop")
        r.stream._put(tok)
        r.emitted += 1
        if r.emitted >= r.max_new:
            out = self._finish_slot(coh, r, "length")
            return (1, out[1])
        self._tokens[r.slot] = tok
        self._active[r.slot] = True
        return (1, True)

    def _finish_slot(self, coh: _Cohort, r: _GenRequest, reason: str,
                     error: Optional[BaseException] = None):
        s = r.slot
        r.stream._finish(reason, error)
        self.metrics.record_finish(reason)
        if r.blocks:
            coh.allocator.free(r.blocks)
            r.blocks = []
        if r.shared_blocks:
            # cache-custody blocks: drop this sequence's reference;
            # refcount-0 blocks park in the LRU for the next identical
            # prefix (eviction under pool pressure frees them)
            coh.prefix.release(r.shared_blocks)
            r.shared_blocks = []
        if coh.prefix is not None:
            self.metrics.set_prefix_gauges(coh.prefix.stats())
        coh.slots.discard(s)
        self._active[s] = False
        with self._cond:
            del self._slot_req[s]
            self._slots_free.add(s)
            self._cond.notify_all()
        return (0, False)

    def _drop_cohorts(self) -> None:
        for c in self._cohorts:
            self._retire(c)
        self._cohorts = []

    def _fail_all(self, exc: BaseException):
        """A dispatch-side failure resolves every caller: queued and
        in-flight requests fail with ``exc`` and release their blocks and
        slots (requests whose prefill raised included). Every cohort is
        dropped, so the next admission builds a fresh pool and graph."""
        self.metrics.record_rejection("error")
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            reqs = list(self._slot_req.values())
        for r in queued:
            r.stream._finish("error", exc)
        for r in reqs:
            self._finish_slot(r.cohort, r, "error", exc)
        self._drop_cohorts()

    def _shutdown_flush(self):
        err = DrainingError(f"generation model '{self.name}' stopped")
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            reqs = list(self._slot_req.values())
        for r in queued:
            r.stream._finish("shutdown", err)
            self.metrics.record_finish("shutdown")
        for r in reqs:
            self._finish_slot(r.cohort, r, "shutdown", GenerationClosedError(
                "engine stopped mid-generation"))
        self._drop_cohorts()

    # ------------------------------------------------------------- lifecycle
    def stop(self, drain: bool = True, timeout: float = 10.0):
        """drain=True: refuse new work but let queued and in-flight
        generations complete (bounded by ``timeout``); drain=False:
        terminate everything now. Either way every stream is finished."""
        with self._cond:
            self._draining = True
            if not drain:
                for r in list(self._queue):
                    r.stream._finish("shutdown", DrainingError(
                        f"model '{self.name}' shut down before admission"))
                self._queue.clear()
                for r in self._slot_req.values():
                    r.cancelled = True
                    r.cancel_reason = "shutdown"
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and \
                (self._queue or self._slot_req):
            time.sleep(0.005)
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=5.0)
        self._shutdown_flush()    # in case the thread wedged
