"""Generation metrics: time to first token, decode rate, request outcomes.

A minimal counterpart of ``deeplearning4j_tpu/serving/generation/metrics.py``:
the local snapshot only (no telemetry registry yet), with time to first
token per request, per-decode-step latency and the decode rate (tokens that
decode steps emitted over the time those steps took).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


_WINDOW = 4096          # latest samples kept for the percentiles


class GenerationMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._ttft_ms = deque(maxlen=_WINDOW)
        self._step_ms = deque(maxlen=_WINDOW)
        self.requests = 0
        self.tokens_out = 0
        self.prefills = 0
        self.prefill_rows = 0
        self.decode_steps = 0
        self.decode_slot_steps = 0          # active slots summed per step
        self.decode_tokens = 0
        self.decode_ms = 0.0
        self.slots = 0
        self.finished: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {"full": 0, "exhausted": 0,
                                         "draining": 0, "deadline": 0,
                                         "error": 0}
        self._t0 = time.monotonic()

    def record_request(self) -> None:
        with self._lock:
            self.requests += 1

    def record_prefill(self, rows: int, ttft_ms_per_row,
                       emitted: int = 0) -> None:
        with self._lock:
            self.prefills += 1
            self.prefill_rows += rows
            self._ttft_ms.extend(ttft_ms_per_row)
            self.tokens_out += emitted          # each row's FIRST token

    def record_decode_step(self, step_ms: float, active_slots: int,
                           emitted: int, *, slots: int) -> None:
        with self._lock:
            self.decode_steps += 1
            self.decode_slot_steps += active_slots
            self.decode_tokens += emitted
            self.decode_ms += step_ms
            self.tokens_out += emitted
            self._step_ms.append(step_ms)
            self.slots = slots

    def record_finish(self, reason: str) -> None:
        with self._lock:
            self.finished[reason] = self.finished.get(reason, 0) + 1

    def record_rejection(self, kind: str) -> None:
        with self._lock:
            self.rejected[kind] = self.rejected.get(kind, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            ttft = sorted(self._ttft_ms)
            step = sorted(self._step_ms)
            occ = (self.decode_slot_steps / (self.decode_steps * self.slots)
                   if self.decode_steps and self.slots else 0.0)
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
                "finished": dict(self.finished),
                "rejected": dict(self.rejected),
                "uptime_s": time.monotonic() - self._t0,
            }
