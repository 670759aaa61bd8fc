"""Memory profiler: tagged-tensor accounting and a black box for OOMs.

Counterpart of ``deeplearning4j_tpu/telemetry/memprof.py``: ``tag``,
``snapshot``, ``snapshot_cached``, ``live_array_groups``,
``live_bytes_by_device``, ``publish_gauges``, ``flightrec_section`` and
``clear_tags``, with the reference's JSON shapes, served on
``POST /debug/memprof`` and embedded in every flight-recorder dump.

Difference: torch has no ``jax.live_arrays()``, so the port cannot walk
every live tensor. It keeps WEAK references to the tensors ``tag`` sees
(the Solver tags its parameters and optimiser state; the generation
programs tag their KV block pools as ``generation.<model>.kvcache``)
and :func:`snapshot` groups the live tagged tensors by (shape, dtype,
owner); a tensor that shares storage with one already counted (a view,
a rank's slice of a pool) is counted once, at its storage's bytes. On
the card the rest of the allocator's allocated bytes
(``torch.cuda.memory_stats``) becomes one ``untagged`` row, so the
table's total is the card's allocated total; on the CPU there is no
allocator to ask and no such row. A tagged tensor that dies drops out
by itself (the weak reference), which the reference's (shape, dtype)
hint table cannot do. ``tag`` takes a tensor or nested dicts, lists and
tuples of them.

Everything here reads metadata (shape, dtype, storage size, device) and
host-side allocator counters: no device value, no sync. A snapshot walks
the tagged tensors on the calling thread: call it from scrape handlers,
epoch boundaries or dump triggers, not from a loop thread.
"""
from __future__ import annotations

import logging
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry
from .spans import current_span_path

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["tag", "snapshot", "snapshot_cached", "live_array_groups",
           "live_bytes_by_device", "publish_gauges", "flightrec_section",
           "clear_tags"]

# id(tensor) -> (weakref, owner); bounded so a churning run cannot grow it
_MAX_TAGS = 65536
_tags: Dict[int, Tuple["weakref.ref", str]] = {}
# re-entrant: a weak reference's callback can run inside ``tag`` (a
# collection while it allocates) and takes the lock again
_tags_lock = threading.RLock()


def _leaves(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tag(tree, owner: Optional[str] = None) -> int:
    """Label every tensor of ``tree`` (a tensor, or nested dicts, lists and
    tuples of them) with ``owner`` (default: the active span path).
    Returns the number of tensors tagged. Metadata only."""
    label = owner or current_span_path() or "untagged"
    n = 0
    with _tags_lock:
        for t in _leaves(tree):
            key = id(t)
            _tags[key] = (weakref.ref(t, lambda _r, k=key: _drop(k, _r)),
                          label)
            n += 1
        if len(_tags) > _MAX_TAGS:
            for k in list(_tags)[:len(_tags) - _MAX_TAGS]:
                del _tags[k]
    return n


def _drop(key: int, ref) -> None:
    with _tags_lock:
        cur = _tags.get(key)
        if cur is not None and cur[0] is ref:
            del _tags[key]


def clear_tags() -> None:
    with _tags_lock:
        _tags.clear()


def _live_tagged() -> List[Tuple[object, str]]:
    with _tags_lock:
        items = list(_tags.values())
    out = []
    for ref, owner in items:
        t = ref()
        if t is not None:
            out.append((t, owner))
    return out


def _dev_key(t) -> str:
    """``device<i>`` for card i (the reference's key), ``cpu`` else."""
    d = t.device
    return f"device{d.index or 0}" if d.type == "cuda" else d.type


def _walk():
    """One pass over the live tagged tensors: (groups {(shape, dtype,
    owner): [count, bytes]}, bytes by device key, tensors counted). A
    storage is counted once, at its own size."""
    groups: Dict[Tuple[tuple, str, str], List[float]] = {}
    per_dev: Dict[str, float] = {}
    seen = set()
    n = 0
    for t, owner in _live_tagged():
        try:
            st = t.untyped_storage()
            key = (t.device.type, t.device.index, st.data_ptr())
            nbytes = 0.0 if key in seen else float(st.nbytes())
            seen.add(key)
            g = (tuple(t.shape), str(t.dtype).replace("torch.", ""), owner)
        except Exception:           # a freed or meta tensor mid-walk
            continue
        rec = groups.setdefault(g, [0.0, 0.0])
        rec[0] += 1
        rec[1] += nbytes
        dk = _dev_key(t)
        per_dev[dk] = per_dev.get(dk, 0.0) + nbytes
        n += 1
    return groups, per_dev, n


def _cuda_stats() -> Dict[str, dict]:
    import torch
    out: Dict[str, dict] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        try:
            s = torch.cuda.memory_stats(i)
            limit = torch.cuda.get_device_properties(i).total_memory
        except Exception:
            continue
        out[f"device{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(limit)}
    return out


def _rows(groups) -> List[dict]:
    rows = [{"shape": list(shape), "dtype": dtype, "owner": owner,
             "count": int(cnt), "total_bytes": int(tb)}
            for (shape, dtype, owner), (cnt, tb) in groups.items()]
    rows.sort(key=lambda r: -r["total_bytes"])
    return rows


def live_array_groups(top_k: int = 10) -> List[dict]:
    """Top-K (shape, dtype, owner) groups of the live tagged tensors by
    total bytes: [{shape, dtype, owner, count, total_bytes}]."""
    return _rows(_walk()[0])[:top_k]


def live_bytes_by_device() -> Dict[str, float]:
    """Tagged bytes per device key (``device0`` for card 0, ``cpu``)."""
    return _walk()[1]


def snapshot(top_k: int = 10) -> dict:
    """One JSON-ready memory profile: the tagged bytes and tensors, the
    per-device totals, the allocator's counters where there is a card,
    and the top-K (shape, dtype, owner) table, with one ``untagged`` row
    a card for the allocated bytes no tag covers."""
    groups, per_dev, n = _walk()
    top = _rows(groups)
    device_stats = _cuda_stats()
    for dk, st in device_stats.items():
        rest = st["bytes_in_use"] - int(per_dev.get(dk, 0.0))
        if rest > 0:
            top.append({"shape": [], "dtype": "", "owner": "untagged",
                        "device": dk, "count": 0, "total_bytes": rest})
    top.sort(key=lambda r: -r["total_bytes"])
    total = sum(per_dev.values())
    return {"total_live_bytes": int(total),
            "live_arrays": n,
            "live_bytes_by_device": {k: int(v)
                                     for k, v in sorted(per_dev.items())},
            "device_stats": device_stats,
            "top": top[:top_k]}


_snap_cache = (0.0, None, 0)       # (monotonic, snapshot, top_k walked)
_snap_lock = threading.Lock()


def snapshot_cached(top_k: int = 10, max_age_s: float = 2.0) -> dict:
    """:func:`snapshot` with a small time-based cache, for surfaces that
    poll (``/metrics`` scrapes, repeat-fire flight dumps)."""
    import time as _time
    global _snap_cache
    now = _time.monotonic()
    with _snap_lock:
        t, snap, walked_k = _snap_cache
        if snap is not None and now - t < max_age_s and walked_k >= top_k:
            out = dict(snap)
            out["top"] = snap["top"][:top_k]
            return out
    walk_k = max(top_k, 10)
    snap = snapshot(top_k=walk_k)
    with _snap_lock:
        _snap_cache = (now, snap, walk_k)
    out = dict(snap)
    out["top"] = snap["top"][:top_k]
    return out


def publish_gauges(registry: Optional[MetricsRegistry] = None) -> dict:
    """Set ``memprof.live_bytes`` / ``memprof.live_arrays`` and
    ``<device>.live_bytes_in_use`` gauges from the tagged tensors (each
    gauge keeps its own high-watermark). Returns the values set."""
    reg = registry or get_registry()
    if not reg.enabled:
        return {}
    _, per_dev, n = _walk()
    total = sum(per_dev.values())
    out = {"memprof.live_bytes": total, "memprof.live_arrays": float(n)}
    reg.gauge("memprof.live_bytes").set(total)
    reg.gauge("memprof.live_arrays").set(float(n))
    for dk, v in per_dev.items():
        name = f"{dk}.live_bytes_in_use"
        reg.gauge(name).set(v)
        out[name] = v
    return out


def flightrec_section(top_k: int = 8) -> Optional[dict]:
    """Compact memory profile for flight-recorder dumps; None instead of
    raising."""
    try:
        return snapshot(top_k=top_k)
    except Exception as e:        # pragma: no cover - defensive
        log.debug("memprof flightrec section failed: %s", e)
        return None
