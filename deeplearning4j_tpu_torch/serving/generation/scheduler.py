"""Continuous batching: slot-based decode scheduling with step-boundary
admission and per-token streams.

Counterpart of ``deeplearning4j_tpu/serving/generation/scheduler.py``
(``TokenStream``, ``ModelRuntime``: ``submit`` / ``_loop`` / ``_admit`` /
``_prefill_misses`` / ``_plain_step`` / ``_finish_slot`` / ``stop``),
including its ``adapter != "paged"`` paths: a model served through the
state adapter allocates no cache blocks, and its prefill writes each
request's recurrent state into the request's slot.
One dispatch thread per model owns the decode loop:

    loop:  admit (bucketed prefill of queued requests into free slots)
           -> one decode step (ALL in-flight sequences advance one token)
           -> emit tokens to per-request TokenStreams, retire finished
              slots (stop token / max_tokens / deadline / shutdown), which
              frees their cache blocks for the next admission

Admission happens at step boundaries only: a new request never stalls
in-flight decode, it lands in the next step's batch. The host side is
numpy; device work goes through the ``GenerationProgramSet``, whose kernels
launch from this thread on its current CUDA stream.

The reference's cohorts (hot-swap), prefix cache, speculative decoding and
telemetry events come with later slices; here one cache pool and one block
allocator live as long as the runtime.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..errors import (BlockPoolExhaustedError, DeadlineExceededError,
                      DrainingError, GenerationClosedError, QueueFullError,
                      ShapeMismatchError)
from .kvcache import BlockAllocator
from .metrics import GenerationMetrics
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

    # ---------------------------------------------------- producer (loop)
    def _put(self, tok: int) -> None:
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


class _GenRequest:
    __slots__ = ("prompt", "max_new", "temperature", "top_k", "stop",
                 "deadline", "stream", "slot", "blocks", "emitted",
                 "cancelled", "enqueue_t")

    def __init__(self, prompt: np.ndarray, max_new: int, temperature: float,
                 top_k: int, stop: frozenset, deadline: float):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.stop = stop
        self.deadline = deadline
        self.stream = TokenStream()
        self.slot: Optional[int] = None
        self.blocks: List[int] = []          # freed at finish
        self.emitted = 0
        self.cancelled = False              # set by stop(drain=False)
        self.enqueue_t = time.monotonic()


class ModelRuntime:
    """Scheduler + device state for one generation model."""

    def __init__(self, name: str, ps: GenerationProgramSet):
        self.name = name
        self.ps = ps
        self.config = ps.config
        self.metrics = GenerationMetrics()
        S, mb = self.config.decode_slots, self.config.blocks_per_seq
        self._queue: "deque[_GenRequest]" = deque()
        self._cond = threading.Condition()
        self._slots_free: Set[int] = set(range(S))
        self._slot_req: Dict[int, _GenRequest] = {}
        self._tokens = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._active = np.zeros(S, np.bool_)
        self._tables = np.zeros((S, mb), np.int64)
        self._cache = ps.make_cache()
        self._allocator = BlockAllocator(self.config.num_blocks)
        self._gen = ps.fresh_generator()
        self._draining = False
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"generation-{name}")
        self._thread.start()

    # -------------------------------------------------------------- admission
    def submit(self, prompt, *, max_new: int, temperature: float = 0.0,
               top_k: int = 0, stop: Sequence[int] = (),
               timeout: Optional[float] = None) -> TokenStream:
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
        need = cfg.blocks_needed(plen, max_new)
        if self.ps.adapter == "paged" and need > cfg.num_blocks - 1:
            raise BlockPoolExhaustedError(
                f"request needs {need} cache blocks but the pool only has "
                f"{cfg.num_blocks - 1} — lower max_tokens or grow "
                f"num_blocks; retry will not help at this size",
                retryable=False)
        timeout = cfg.default_timeout_s if timeout is None else timeout
        req = _GenRequest(prompt, int(max_new), float(temperature),
                          int(top_k), frozenset(int(s) for s in stop),
                          time.monotonic() + timeout)
        with self._cond:
            if self._draining or self._stopped:
                self.metrics.record_rejection("draining")
                raise DrainingError(
                    f"generation model '{self.name}' is draining/stopped")
            if len(self._queue) >= cfg.queue_limit:
                if self.ps.adapter == "paged" and \
                        self._allocator.free_blocks == 0:
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
            self._queue.append(req)
            self._cond.notify_all()
        return req.stream

    # ------------------------------------------------------------ loop body
    def _loop(self):
        try:
            while True:
                with self._cond:
                    if self._stopped:
                        break
                    if not self._queue and not self._slot_req:
                        self._cond.wait(0.02)
                        continue
                try:
                    self._admit()
                    self._step()
                except Exception as e:       # nobody may hang on a failure
                    self._fail_all(e)
        finally:
            self._shutdown_flush()

    def _admit(self):
        cfg = self.config
        cands: List[_GenRequest] = []
        now = time.monotonic()
        with self._cond:
            # expire while queued
            keep: "deque[_GenRequest]" = deque()
            while self._queue:
                r = self._queue.popleft()
                if now > r.deadline:
                    self.metrics.record_rejection("deadline")
                    r.stream._finish("deadline", DeadlineExceededError(
                        "deadline expired while queued for admission"))
                else:
                    keep.append(r)
            self._queue = keep
            max_p = cfg.prefill_batches[-1]
            paged = self.ps.adapter == "paged"
            while self._queue and self._slots_free and len(cands) < max_p:
                r = self._queue[0]
                need = cfg.blocks_needed(len(r.prompt), r.max_new)
                if paged and need > self._allocator.free_blocks:
                    break        # head-of-line: wait for blocks to free
                self._queue.popleft()
                # registered for failure delivery before its blocks, so a
                # failure below resolves this caller through _fail_all
                r.slot = self._slots_free.pop()
                self._slot_req[r.slot] = r
                if paged:
                    r.blocks = self._allocator.alloc(need)
                cands.append(r)
        if cands:
            self._prefill_misses(cands)

    def _prefill_misses(self, cands: List[_GenRequest]):
        cfg = self.config
        mb = cfg.blocks_per_seq
        P = cfg.prefill_rung(len(cands))
        L = cfg.prompt_rung(max(len(r.prompt) for r in cands))
        tokens = np.zeros((P, L), np.int64)
        lengths = np.ones(P, np.int64)
        tables_p = np.zeros((P, mb), np.int64)      # padding rows -> trash
        slots = np.full(P, cfg.decode_slots, np.int64)   # ... and trash slot
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
        first = self.ps.run_prefill(self._cache, tokens, lengths, tables_p,
                                    slots, self._gen, temp, topk)
        now = time.monotonic()
        emitted = 0
        for i, r in enumerate(cands):
            s = r.slot
            self._tables[s] = tables_p[i]
            self._pos[s] = len(r.prompt)
            self._temp[s] = r.temperature
            self._topk[s] = r.top_k
            did_emit, _ = self._slot_emit(r, int(first[i]), now)
            emitted += did_emit
        self.metrics.record_prefill(
            len(cands), [(now - r.enqueue_t) * 1e3 for r in cands], emitted)

    def _step(self):
        live = [s for s in sorted(self._slot_req) if self._active[s]]
        if live:
            self._plain_step(live)

    def _plain_step(self, live: List[int]):
        S = self.config.decode_slots
        mask = np.zeros(S, np.bool_)
        mask[live] = True
        t0 = time.perf_counter()
        nxt = self.ps.run_decode(self._cache, self._tokens, self._pos,
                                 self._tables, mask, self._gen, self._temp,
                                 self._topk)
        dt_ms = (time.perf_counter() - t0) * 1e3
        now = time.monotonic()
        emitted = 0
        for s in live:
            did_emit, cont = self._slot_emit(self._slot_req[s], int(nxt[s]),
                                             now)
            emitted += did_emit
            if cont:
                self._pos[s] += 1
        self.metrics.record_decode_step(dt_ms, len(live), emitted, slots=S)

    def _slot_emit(self, r: _GenRequest, tok: int, now: float):
        """Handle one sampled token for a slot: emit or terminate. Returns
        (emitted, continuing)."""
        if r.cancelled:
            # a shutdown surfaces as an ERROR to blocking callers
            return self._finish_slot(r, "shutdown", GenerationClosedError(
                "engine stopped mid-generation"))
        if now > r.deadline:
            return self._finish_slot(
                r, "deadline",
                DeadlineExceededError("deadline expired mid-generation "
                                      f"after {r.emitted} tokens"))
        if tok in r.stop:
            return self._finish_slot(r, "stop")
        r.stream._put(tok)
        r.emitted += 1
        if r.emitted >= r.max_new:
            out = self._finish_slot(r, "length")
            return (1, out[1])
        self._tokens[r.slot] = tok
        self._active[r.slot] = True
        return (1, True)

    def _finish_slot(self, r: _GenRequest, reason: str,
                     error: Optional[BaseException] = None):
        s = r.slot
        r.stream._finish(reason, error)
        self.metrics.record_finish(reason)
        if r.blocks:
            self._allocator.free(r.blocks)
            r.blocks = []
        self._active[s] = False
        with self._cond:
            del self._slot_req[s]
            self._slots_free.add(s)
            self._cond.notify_all()
        return (0, False)

    def _fail_all(self, exc: BaseException):
        """A dispatch-side failure resolves every caller: queued and in-flight
        requests fail with ``exc`` and release their blocks and slots."""
        self.metrics.record_rejection("error")
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            reqs = list(self._slot_req.values())
        for r in queued:
            r.stream._finish("error", exc)
        for r in reqs:
            self._finish_slot(r, "error", exc)

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
            self._finish_slot(r, "shutdown", GenerationClosedError(
                "engine stopped mid-generation"))

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
