"""Generation observability: per-model token, latency, occupancy, prefix
and speculative counters.

Counterpart of ``deeplearning4j_tpu/serving/generation/metrics.py``: the
local snapshot (the ``GET /metrics`` payload) with the reference's keys —
time to first token, per-decode-step latency, slot occupancy, the prefix
cache's hits, misses, tokens saved, copy-on-write copies, evictions,
cached-first-token TTFT and block gauges, the speculative verify windows'
acceptance and tokens per target dispatch, hot swaps, the block pool's
bytes per token and the warm runs the decode loop made on its own
thread after warm-up (the reference counts the process's). The port
adds ``decode_tokens_per_sec`` (tokens that decode steps and verify
windows emitted over the time they took). Every record is mirrored into
the telemetry registry under ``generation.<model>.*``, with the
reference's names, and ``publish`` pushes the snapshot into a
StatsStorage backend, as the reference's do.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List

from ...telemetry import get_registry


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class GenerationMetrics:
    def __init__(self, window: int = 4096, name: str = "default",
                 registry=None):
        self._lock = threading.Lock()
        self.name = name
        self._registry = registry
        self._ttft_ms = deque(maxlen=window)
        self._step_ms = deque(maxlen=window)
        self._tok_t = deque(maxlen=window)       # emission timestamps
        self.requests = 0
        self.tokens_out = 0
        self.prefills = 0
        self.prefill_rows = 0
        self.decode_steps = 0
        self.decode_slot_steps = 0              # active slots summed per step
        self.decode_tokens = 0      # tokens that steps and windows emitted
        self.decode_ms = 0.0                    # ... and the time they took
        self.finished: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {"full": 0, "exhausted": 0,
                                         "draining": 0, "deadline": 0,
                                         "error": 0}
        self.swaps = 0
        self.decode_recompiles = 0
        self.slots = 0
        self.blocks_total = 0
        self.kv_bytes_per_token = None
        # prefix-cache economics
        self._ttft_cached_ms = deque(maxlen=window)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.cow_copies = 0
        self.prefix_evictions = 0
        self._prefix_gauges: dict = {}
        # speculative decoding
        self._verify_ms = deque(maxlen=window)
        self.verify_steps = 0
        self.verify_slot_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        self._t0 = time.monotonic()
        self._rate_t = self._t0

    @property
    def registry(self):
        # resolved per recording so a test-swapped global registry applies
        return self._registry if self._registry is not None else get_registry()

    # ------------------------------------------------------------- recording
    def record_request(self) -> None:
        with self._lock:
            self.requests += 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.requests").inc()

    def record_prefill(self, rows: int, ttft_ms_per_row,
                       emitted: int = 0) -> None:
        now = time.monotonic()
        with self._lock:
            self.prefills += 1
            self.prefill_rows += rows
            self._ttft_ms.extend(ttft_ms_per_row)
            self.tokens_out += emitted          # each row's FIRST token
            self._tok_t.extend([now] * emitted)
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.prefills").inc()
            if emitted:
                reg.counter(
                    f"generation.{self.name}.tokens_out").inc(emitted)
            h = reg.histogram(f"generation.{self.name}.ttft_ms")
            for v in ttft_ms_per_row:
                h.observe(v)

    def record_decode_step(self, step_ms: float, active_slots: int,
                           emitted: int, *, slots: int, blocks_used: int = 0,
                           blocks_total: int = 0,
                           queue_depth: int = 0) -> None:
        now = time.monotonic()
        with self._lock:
            self.decode_steps += 1
            self.decode_slot_steps += active_slots
            self.decode_tokens += emitted
            self.decode_ms += step_ms
            self.tokens_out += emitted
            self._step_ms.append(step_ms)
            self._tok_t.extend([now] * emitted)
            self.slots = slots
            self.blocks_total = blocks_total
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.decode_steps").inc()
            reg.counter(f"generation.{self.name}.tokens_out").inc(emitted)
            reg.histogram(
                f"generation.{self.name}.decode_step_ms").observe(step_ms)
            self._loop_gauges(reg, now, active_slots, slots, blocks_used,
                              queue_depth)

    def _loop_gauges(self, reg, now, active_slots, slots, blocks_used,
                     queue_depth) -> None:
        reg.gauge(f"generation.{self.name}.slot_occupancy").set(
            active_slots / slots if slots else 0.0)
        reg.gauge(f"generation.{self.name}.blocks_in_use").set(blocks_used)
        reg.gauge(f"generation.{self.name}.queue_depth").set(queue_depth)
        # throttled: the rate scan over the timestamp ring is not free and
        # the decode step is the serving hot loop
        if now - self._rate_t >= 0.5:
            self._rate_t = now
            reg.gauge(f"generation.{self.name}.tokens_per_sec").set(
                self._recent_tokens_per_sec(now))

    # -------------------------------------------------------- prefix cache
    def record_prefix_hit(self, tokens_saved: int) -> None:
        with self._lock:
            self.prefix_hits += 1
            self.prefix_tokens_saved += tokens_saved
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.prefix.hits").inc()
            if tokens_saved:
                reg.counter(
                    f"generation.{self.name}.prefix.tokens_saved").inc(
                    tokens_saved)
            self._hit_rate_gauge(reg)

    def record_prefix_miss(self) -> None:
        with self._lock:
            self.prefix_misses += 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.prefix.misses").inc()
            self._hit_rate_gauge(reg)

    def _hit_rate_gauge(self, reg) -> None:
        total = self.prefix_hits + self.prefix_misses
        if total:
            reg.gauge(f"generation.{self.name}.prefix_hit_rate").set(
                round(self.prefix_hits / total, 4))

    def record_cow(self) -> None:
        with self._lock:
            self.cow_copies += 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.prefix.cow_copies").inc()

    def record_prefix_evictions(self, n: int) -> None:
        with self._lock:
            self.prefix_evictions += n
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.prefix.evictions").inc(n)

    def record_cached_first_token(self, ttft_ms: float) -> None:
        """TTFT for a cache-hit admission (prefill skipped; the first token
        fell out of the replay's final decode step)."""
        with self._lock:
            self._ttft_cached_ms.append(ttft_ms)
        reg = self.registry
        if reg.enabled:
            reg.histogram(
                f"generation.{self.name}.ttft_cached_ms").observe(ttft_ms)

    def set_prefix_gauges(self, stats: dict) -> None:
        """The active cohort's block-pool economics (shared blocks, cached
        LRU size): the snapshot's prefix gauges."""
        with self._lock:
            self._prefix_gauges = dict(stats)
        reg = self.registry
        if reg.enabled:
            reg.gauge(f"generation.{self.name}.prefix.shared_blocks").set(
                stats.get("shared_blocks", 0))
            reg.gauge(
                f"generation.{self.name}.prefix.cached_lru_blocks").set(
                stats.get("cached_lru_blocks", 0))

    # ------------------------------------------------- speculative decoding
    def record_verify(self, step_ms: float, active_slots: int, *,
                      proposed: int, accepted: int, emitted: int,
                      slots: int, blocks_used: int = 0,
                      blocks_total: int = 0, queue_depth: int = 0) -> None:
        """One draft-propose + verify window: ``accepted`` draft tokens
        matched the target's greedy choice; ``emitted`` includes each
        slot's correction token (the yield per target dispatch)."""
        now = time.monotonic()
        with self._lock:
            self.verify_steps += 1
            self.verify_slot_steps += active_slots
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            self.spec_emitted += emitted
            self.tokens_out += emitted
            self.decode_tokens += emitted
            self.decode_ms += step_ms
            # verify windows are k+1-token passes: kept out of the
            # one-token decode_step_ms population
            self._verify_ms.append(step_ms)
            self._tok_t.extend([now] * emitted)
            self.slots = slots
            self.blocks_total = blocks_total
            per_verify = (self.spec_emitted / self.verify_slot_steps
                          if self.verify_slot_steps else 0.0)
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.spec.verify_steps").inc()
            reg.counter(f"generation.{self.name}.spec.proposed").inc(proposed)
            reg.counter(f"generation.{self.name}.spec.accepted").inc(accepted)
            reg.counter(f"generation.{self.name}.tokens_out").inc(emitted)
            reg.histogram(
                f"generation.{self.name}.verify_step_ms").observe(step_ms)
            reg.gauge(
                f"generation.{self.name}.spec.accepted_per_verify").set(
                round(per_verify, 3))
            self._loop_gauges(reg, now, active_slots, slots, blocks_used,
                              queue_depth)

    def record_finish(self, reason: str) -> None:
        with self._lock:
            self.finished[reason] = self.finished.get(reason, 0) + 1
        reg = self.registry
        if reg.enabled:
            reg.counter(
                f"generation.{self.name}.finished.{reason}").inc()

    def record_rejection(self, kind: str) -> None:
        with self._lock:
            self.rejected[kind] = self.rejected.get(kind, 0) + 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.rejected.{kind}").inc()

    def record_swap(self) -> None:
        with self._lock:
            self.swaps += 1
        reg = self.registry
        if reg.enabled:
            reg.counter(f"generation.{self.name}.hot_swaps").inc()

    def record_recompile(self, n: int) -> None:
        """Warm runs and captures the model's decode loop made on its own
        thread while serving (the reference counts every backend compile
        in the process there); warm-up before traffic, a hot swap's
        warm-up and other engines' warm runs are not counted."""
        with self._lock:
            self.decode_recompiles = n

    def set_kv_bytes_per_token(self, v) -> None:
        """Block-pool bytes per token slot; None (state adapter) keeps
        nothing."""
        if v is None:
            return
        with self._lock:
            self.kv_bytes_per_token = float(v)
        reg = self.registry
        if reg.enabled:
            reg.gauge(f"generation.{self.name}.kv_bytes_per_token").set(
                float(v))

    def _recent_tokens_per_sec(self, now: float, window_s: float = 5.0):
        if not self._tok_t:
            return 0.0
        cut = now - window_s
        # the ring is count-bounded: at high rates it evicts timestamps
        # still inside the window — measure over the span actually kept
        oldest = self._tok_t[0]
        if oldest > cut:
            cut = oldest
            span = max(now - cut, 1e-3)
        else:
            span = max(min(window_s, now - self._t0), 1e-3)
        n = 0
        for t in reversed(self._tok_t):
            if t < cut:
                break
            n += 1
        return round(n / span, 2)

    # ------------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            ttft = sorted(self._ttft_ms)
            ttft_c = sorted(self._ttft_cached_ms)
            step = sorted(self._step_ms)
            verify = sorted(self._verify_ms)
            # occupancy over both step kinds: a speculating engine advances
            # its slots through verify windows
            steps_all = self.decode_steps + self.verify_steps
            occ = ((self.decode_slot_steps + self.verify_slot_steps)
                   / (steps_all * self.slots)
                   if steps_all and self.slots else 0.0)
            lookups = self.prefix_hits + self.prefix_misses
            return {
                "requests": self.requests,
                "tokens_out": self.tokens_out,
                "prefills": self.prefills,
                "prefill_rows": self.prefill_rows,
                "decode_steps": self.decode_steps,
                "ttft_ms": {"p50": _percentile(ttft, 0.50),
                            "p99": _percentile(ttft, 0.99)},
                "decode_step_ms": {"p50": _percentile(step, 0.50),
                                   "p99": _percentile(step, 0.99)},
                "decode_tokens_per_sec": (
                    self.decode_tokens / (self.decode_ms / 1e3)
                    if self.decode_ms else 0.0),
                "slot_occupancy": occ,
                "tokens_per_sec_recent": self._recent_tokens_per_sec(now),
                "finished": dict(self.finished),
                "rejected": dict(self.rejected),
                "hot_swaps": self.swaps,
                "decode_recompiles": self.decode_recompiles,
                "kv_bytes_per_token": self.kv_bytes_per_token,
                "uptime_s": now - self._t0,
                "prefix": {
                    "hits": self.prefix_hits,
                    "misses": self.prefix_misses,
                    "hit_rate": (round(self.prefix_hits / lookups, 4)
                                 if lookups else 0.0),
                    "tokens_saved": self.prefix_tokens_saved,
                    "cow_copies": self.cow_copies,
                    "evictions": self.prefix_evictions,
                    "shared_blocks": self._prefix_gauges.get(
                        "shared_blocks", 0),
                    "cached_lru_blocks": self._prefix_gauges.get(
                        "cached_lru_blocks", 0),
                    "cached_blocks": self._prefix_gauges.get(
                        "cached_blocks", 0),
                    "ttft_cached_ms": {
                        "p50": _percentile(ttft_c, 0.50),
                        "p99": _percentile(ttft_c, 0.99)},
                },
                "speculative": {
                    "verify_steps": self.verify_steps,
                    "verify_step_ms": {
                        "p50": _percentile(verify, 0.50),
                        "p99": _percentile(verify, 0.99)},
                    "proposed": self.spec_proposed,
                    "accepted": self.spec_accepted,
                    "emitted": self.spec_emitted,
                    "accepted_tokens_per_verify": (
                        round(self.spec_emitted / self.verify_slot_steps, 3)
                        if self.verify_slot_steps else 0.0),
                    "proposals_accepted_per_verify": (
                        round(self.spec_accepted / self.verify_slot_steps, 3)
                        if self.verify_slot_steps else 0.0),
                },
            }

    def publish(self, storage, session_id: str = "generation",
                worker_id: str = "default") -> dict:
        snap = self.snapshot()
        storage.put_update(session_id, worker_id, snap)
        return snap
