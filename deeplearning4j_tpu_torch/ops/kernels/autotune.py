"""Autotuning harness: measured tiling decisions, cached per (kernel,
shape-sig, backend).

Counterpart of ``deeplearning4j_tpu/ops/kernels/autotune.py``: the same
``AutotuneCache`` (a JSON file, atomic writes, a corrupt or absent file is
an empty cache), ``get_cache``, ``cached_decision``, ``decisions_for`` and
``decide`` (measure each candidate with the caller's thunk, keep the
argmin; without a thunk record that the defaults stand, with the reason;
count each replay on its record).

Deliberate differences:

- The default path is the port's own,
  ``~/.cache/deeplearning4j_tpu_torch/autotune.json``; the variable that
  overrides it is the reference's ``DL4J_TPU_AUTOTUNE_CACHE``, so both
  packages may share one file.
- The backend part of a key is ``cuda:<torch.cuda.get_device_name()>`` on
  a card and ``torch-cpu`` without one. It never equals the reference's
  (``cpu``, ``tpu``), so a decision the JAX package wrote, or one taken on
  another card, is never replayed here, and :func:`decisions_for` lists
  the port's decisions only.

No kernel of the port consults the cache today: K1-K4 have fixed tiles,
and the plans of K5-K8 (``fwd_plan``, ``loop_plan``, ``tile_plan``) are
computed from the card's SM count and co-residency, not measured.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

_LOCK = threading.Lock()
_CACHE: Optional["AutotuneCache"] = None
_PORT_BACKENDS = ("torch-", "cuda:")


def cache_path() -> str:
    p = os.environ.get("DL4J_TPU_AUTOTUNE_CACHE")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "deeplearning4j_tpu_torch", "autotune.json")


class AutotuneCache:
    """JSON-file-backed decision store. Atomic writes (tmp + rename, the
    repo's checkpoint discipline); a corrupt/absent file is an empty
    cache, never an error."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or cache_path()
        self._decisions: Dict[str, Dict[str, Any]] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
            if isinstance(data, dict) and data.get("autotune_cache") == 1:
                dec = data.get("decisions")
                if isinstance(dec, dict):
                    self._decisions = dec
        except (OSError, ValueError):
            self._decisions = {}

    def _save(self) -> None:
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump({"autotune_cache": 1,
                           "decisions": self._decisions}, f, indent=1,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            pass    # a read-only FS degrades to per-process decisions

    @staticmethod
    def key(kernel: str, shape_sig: str, backend: str) -> str:
        return f"{kernel}|{shape_sig}|{backend}"

    def lookup(self, kernel: str, shape_sig: str,
               backend: str) -> Optional[Dict[str, Any]]:
        return self._decisions.get(self.key(kernel, shape_sig, backend))

    def decisions_for(self, kernel: str) -> Dict[str, Dict[str, Any]]:
        pre = kernel + "|"
        return {k: v for k, v in self._decisions.items()
                if k.startswith(pre)
                and k.rsplit("|", 1)[-1].startswith(_PORT_BACKENDS)}

    def store(self, kernel: str, shape_sig: str, backend: str,
              record: Dict[str, Any]) -> None:
        self._decisions[self.key(kernel, shape_sig, backend)] = record
        self._save()


def get_cache() -> AutotuneCache:
    global _CACHE
    with _LOCK:
        if _CACHE is None or _CACHE.path != cache_path():
            _CACHE = AutotuneCache()
        return _CACHE


def _backend() -> str:
    """This process's backend part of a key: the card by name, or the
    CPU."""
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return "torch-cpu"


def cached_decision(kernel: str, shape_sig: str,
                    backend: Optional[str] = None) -> Optional[Sequence]:
    """Replay path: the cached choice for this rig, or None. Counts the
    replay on the record (proof no re-measurement happened)."""
    cache = get_cache()
    rec = cache.lookup(kernel, shape_sig, backend or _backend())
    if rec is None or "choice" not in rec:
        return None
    rec["replays"] = int(rec.get("replays", 0)) + 1
    cache._save()
    return rec["choice"]


def decisions_for(kernel: str) -> Dict[str, Dict[str, Any]]:
    return get_cache().decisions_for(kernel)


def decide(kernel: str, shape_sig: str,
           candidates: Sequence[Tuple],
           measure: Optional[Callable[[Tuple], float]],
           default: Tuple, *, force: bool = False) -> Dict[str, Any]:
    """Choose a tiling for (kernel, shape_sig) on this backend.

    ``candidates`` — tuples to try; ``measure(candidate) -> seconds`` (or
    None when measurement is meaningless here, e.g. on the CPU, which runs
    the plain versions); ``default`` — the choice measurements must beat.
    Returns the decision record (and persists it). A cached record
    short-circuits everything unless ``force``.
    """
    backend = _backend()
    cache = get_cache()
    rec = None if force else cache.lookup(kernel, shape_sig, backend)
    if rec is not None and "choice" in rec:
        rec["replays"] = int(rec.get("replays", 0)) + 1
        cache._save()
        return rec

    default = tuple(default)
    if measure is None:
        rec = {"choice": list(default), "default": list(default),
               "changed_default": False, "replays": 0, "measured_ms": {},
               "why": (f"defaults stand: no measurement available on "
                       f"backend {backend!r} (the CPU runs the plain "
                       f"versions: their timings say nothing of a kernel)")}
        cache.store(kernel, shape_sig, backend, rec)
        return rec

    timings: Dict[str, float] = {}
    best, best_t = None, float("inf")
    for cand in candidates:
        cand = tuple(cand)
        try:
            t = float(measure(cand))
        except Exception:               # a candidate that fails to run
            timings[str(list(cand))] = float("nan")
            continue
        timings[str(list(cand))] = t * 1e3
        if t < best_t:
            best, best_t = cand, t
    if best is None:
        best = default
        why = "defaults stand: every candidate failed to measure"
        changed = False
    else:
        changed = best != default
        why = (f"measured argmin over {len(candidates)} candidates"
               + ("" if changed else " — default already optimal"))
    rec = {"choice": list(best), "default": list(default),
           "changed_default": changed, "replays": 0,
           "measured_ms": timings, "why": why}
    cache.store(kernel, shape_sig, backend, rec)
    return rec
