"""Performance observability: the live cost-model accounting layer.

Counterpart of ``deeplearning4j_tpu/telemetry/perf.py``: the shared cost
model (:func:`implied_mfu`, :func:`roofline_dt`, :func:`classify_roofline`),
:class:`ProgramCostIndex` (per-program cost entries keyed by span path,
each paired with a timing histogram the hot loop already observes;
:meth:`~ProgramCostIndex.fold` turns the histogram's new observations into
``perf.<path>.mfu`` / ``.achieved_tflops`` / ``.step_ms`` /
``.roofline_compute_bound`` gauges, off the hot loop),
:class:`StepAccounting` (the ``perf.step.*`` decomposition with deferred
flush), :class:`PerfBaseline` and :func:`baseline_deltas` (the checked-in
``BENCH_r*.json`` trajectory, code ported unchanged),
:func:`decomposition_summary`, :func:`perf_snapshot` and
:func:`write_perf_dump`. ``DL4J_TPU_PERF_ACCOUNTING=0`` turns capture and
fold off, as in the reference.

Deliberate differences:

- **The chip model is the card's.** The reference's defaults, 197 TFLOP/s
  and 819 GB/s (``:82-95``), are a TPU v5e's. Here :func:`peak_tflops`
  and :func:`hbm_gbps` come from :data:`CHIP_PEAKS`, keyed by
  ``torch.cuda.get_device_name()``, by dtype: its one entry is the H100
  SXM's data-sheet peaks (dense bf16 989 TFLOP/s, f32 67, int8 1,979
  TOP/s; HBM 3.35 TB/s), the figures ``chip_smoke.py``'s bounds use. A
  card not in the table, or a program on the CPU, has no peak, and its
  ``mfu`` is None: nothing falls back to a TPU figure. The overrides are
  the reference's (``override=`` / ``peak=`` arguments and the
  ``BENCH_PEAK_TFLOPS`` / ``BENCH_HBM_GBPS`` / ``BENCH_MAX_PLAUSIBLE_MFU``
  variables). A cost entry carries its program's compute ``dtype`` and
  ``device``, which pick the peak it folds against.
- **Costs are counted, not read from a compiler.** There is no XLA
  ``cost_analysis`` (``:103-121``), and the kernels are ``ctypes`` calls
  (``ops/nvcc.py``) no flop counter sees, as XLA cannot see inside a
  Pallas call (``:225-228``). :func:`count_cost` runs one real, eager run
  of the program (a serving bucket's or a generation program's warm run,
  a training step that runs eagerly anyway: the first per-step step, a
  window's warm step) under a ``TorchDispatchMode`` that adds up
  ``torch.utils.flop_counter``'s formulas for every aten op and the
  tensor bytes each op reads and writes (a pre-fusion count, as the
  reference's ``Lowered`` bytes run high), while each hand-written
  kernel's wrapper adds its own analytic count (:func:`note_kernel`: its
  operands' bytes and its model flops; the flash backward's recompute of
  the scores is left out, ``ops/flash_attention.py`` ``_pairs``, so
  ``mfu`` counts the work the model needs, not the work the card did,
  and ``chip_smoke.py``'s bounds, which count the recompute, run higher
  for K2 and K3). The mode reads shapes
  only: it adds no device work and changes no value. A cost is counted
  once per (path, signature) (:meth:`ProgramCostIndex.count`); the
  reference's ``DL4J_TPU_PERF_CAPTURE_AFTER`` deferral, there to skip a
  retrace, has nothing to defer. ``normalize_cost_analysis``,
  ``cost_analysis_of`` and ``maybe_capture`` are not ported.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry

log = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["implied_mfu", "roofline_dt", "classify_roofline", "peak_tflops",
           "hbm_gbps", "max_plausible_mfu", "accounting_enabled",
           "CHIP_PEAKS", "chip_peaks", "count_cost", "note_kernel",
           "CostCount", "ProgramCost", "ProgramCostIndex", "get_cost_index",
           "set_cost_index", "StepAccounting", "PerfBaseline",
           "baseline_deltas", "decomposition_summary", "write_perf_dump",
           "perf_snapshot"]

_ENV_KILL = "DL4J_TPU_PERF_ACCOUNTING"


def accounting_enabled() -> bool:
    """Cost capture + fold master switch (default on; the registry's
    ``enabled`` flag gates it too)."""
    return os.environ.get(_ENV_KILL, "1").lower() not in ("0", "false",
                                                          "off")


# ------------------------------------------------------------ chip model
# card name (as torch.cuda.get_device_name gives it, matched by prefix) ->
# dense peaks in TFLOP/s (TOP/s for int8) by dtype, and HBM GB/s. NVIDIA's
# H100 SXM data sheet, at the 700 W limit.
CHIP_PEAKS: Dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": {"tflops": {"bfloat16": 989.0,
                                         "float16": 989.0,
                                         "float32": 67.0,
                                         "int8": 1979.0},
                              "hbm_gbps": 3350.0},
}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "") if dtype is not None \
        else "bfloat16"


def chip_peaks(device=None) -> Optional[dict]:
    """The :data:`CHIP_PEAKS` entry of ``device`` (a ``torch.device`` or
    string; None: the current card when CUDA is in use), or None for the
    CPU and for a card not in the table."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    elif not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    try:
        name = torch.cuda.get_device_name(device)
    except Exception:
        return None
    for key, peaks in CHIP_PEAKS.items():
        if name.startswith(key):
            return peaks
    return None


def peak_tflops(override: Optional[float] = None, *, dtype=None,
                device=None) -> Optional[float]:
    """Peak TFLOP/s of ``dtype`` (default bf16) on ``device``: the
    override, else ``$BENCH_PEAK_TFLOPS``, else :data:`CHIP_PEAKS`; None
    where there is no peak (the CPU, a card not in the table)."""
    if override is not None:
        return float(override)
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env is not None:
        return float(env)
    peaks = chip_peaks(device)
    if peaks is None:
        return None
    return peaks["tflops"].get(_dtype_name(dtype))


def hbm_gbps(override: Optional[float] = None, *,
             device=None) -> Optional[float]:
    """Memory rate in GB/s: the override, ``$BENCH_HBM_GBPS``, or the
    card's :data:`CHIP_PEAKS` entry (None where there is none)."""
    if override is not None:
        return float(override)
    env = os.environ.get("BENCH_HBM_GBPS")
    if env is not None:
        return float(env)
    peaks = chip_peaks(device)
    return None if peaks is None else float(peaks["hbm_gbps"])


def max_plausible_mfu(override: Optional[float] = None) -> float:
    if override is not None:
        return float(override)
    return float(os.environ.get("BENCH_MAX_PLAUSIBLE_MFU", "0.6"))


def implied_mfu(flops_per_step, dt_s, *, peak: Optional[float] = None,
                dtype=None, device=None) -> Optional[float]:
    """MFU implied by a measured per-step time (None if the flops or the
    peak are unknown)."""
    if not flops_per_step or not dt_s or dt_s <= 0:
        return None
    pk = peak_tflops(peak, dtype=dtype, device=device)
    if not pk:
        return None
    return flops_per_step / dt_s / 1e12 / pk


def roofline_dt(flops_per_step, *, peak: Optional[float] = None,
                mfu_ceiling: Optional[float] = None, dtype=None,
                device=None) -> Optional[float]:
    """Fastest physically plausible per-step time at the MFU ceiling (None
    without a peak)."""
    pk = peak_tflops(peak, dtype=dtype, device=device)
    if not pk:
        return None
    return flops_per_step / (pk * 1e12 * max_plausible_mfu(mfu_ceiling))


def classify_roofline(flops, bytes_accessed, *,
                      peak: Optional[float] = None,
                      gbps: Optional[float] = None, dtype=None,
                      device=None) -> dict:
    """Compute- vs memory-bound classification from arithmetic intensity
    (flops/byte) against the ridge point (peak_flops / bandwidth).
    ``attainable_tflops`` is the roofline ceiling for this intensity. With
    no peak or rate (the CPU) the bound is "unknown"."""
    pk = peak_tflops(peak, dtype=dtype, device=device)
    bw = hbm_gbps(gbps, device=device)
    if not pk or bw is None:
        return {"bound": "unknown", "intensity": None, "ridge": None,
                "attainable_tflops": None}
    ridge = pk * 1e12 / (bw * 1e9) if bw > 0 else float("inf")
    if not flops or not bytes_accessed:
        return {"bound": "unknown", "intensity": None, "ridge": round(ridge, 2),
                "attainable_tflops": None}
    intensity = float(flops) / float(bytes_accessed)
    attainable = min(pk, intensity * bw / 1e3)
    return {"bound": "compute" if intensity >= ridge else "memory",
            "intensity": round(intensity, 3), "ridge": round(ridge, 2),
            "attainable_tflops": round(attainable, 3)}


# ----------------------------------------------------------- cost counts
@dataclass
class CostCount:
    """What :func:`count_cost` counted in its scope: aten ops' flops and
    bytes, and the hand-written kernels' (``kernel_*``) apart."""
    flops: float = 0.0
    bytes: float = 0.0
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0

    @property
    def total_flops(self) -> float:
        return self.flops + self.kernel_flops

    @property
    def total_bytes(self) -> float:
        return self.bytes + self.kernel_bytes


_counting = 0              # count_cost scopes open in the process
_counting_lock = threading.Lock()


def _nbytes(x) -> float:
    import torch
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0.0


def _cost_mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _CostMode(TorchDispatchMode):
        def __init__(self, acc: CostCount):
            super().__init__()
            self.acc = acc

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            fn = flop_registry.get(func._overloadpacket)
            if fn is None:
                # a composite op (``matmul`` reaches here whole under
                # inference mode): count what it decomposes into
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if fn is not None:
                self.acc.flops += float(fn(*args, **kwargs, out_val=out))
            if not getattr(func, "is_view", False):
                self.acc.bytes += sum(_nbytes(a) for a in args) \
                    + sum(_nbytes(v) for v in kwargs.values()) + _nbytes(out)
            return out

    return _CostMode


class count_cost:
    """``with count_cost() as c: run()`` counts one eager run's flops and
    bytes into ``c`` (a :class:`CostCount`). Reads shapes only."""

    def __init__(self):
        self.count = CostCount()
        self._mode = None

    def __enter__(self) -> CostCount:
        global _counting
        self._mode = _cost_mode_class()(self.count)
        with _counting_lock:
            _counting += 1
        self._mode.__enter__()
        return self.count

    def __exit__(self, *exc) -> bool:
        global _counting
        try:
            self._mode.__exit__(*exc)
        finally:
            with _counting_lock:
                _counting -= 1
        return False


def note_kernel(flops: float, *tensors) -> None:
    """A hand-written kernel's wrapper reports one launch: its analytic
    ``flops`` and its operands (each read or written once). A no-op unless
    a :func:`count_cost` scope is open on this thread (or on the thread
    whose backward this is: the dispatch mode travels with autograd)."""
    if not _counting:
        return
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    mode = _get_current_dispatch_mode()
    acc = getattr(mode, "acc", None)
    if isinstance(acc, CostCount):
        acc.kernel_flops += float(flops)
        acc.kernel_bytes += sum(_nbytes(t) for t in tensors)


# ----------------------------------------------------------- cost index
@dataclass
class ProgramCost:
    """One program's counted cost + fold state. ``flops_per_step`` /
    ``bytes_per_step`` are PER STEP; ``steps_per_call`` divides the TIMING
    metric only. ``dtype`` and ``device`` pick the peak the fold uses."""
    path: str
    flops_per_step: Optional[float] = None
    bytes_per_step: Optional[float] = None
    peak_memory_bytes: Optional[float] = None
    steps_per_call: int = 1
    items_per_step: Optional[float] = None
    model_axis_size: int = 1         # tensor-parallel ways
    source: str = "unknown"          # counted | analytic
    timing_metric: Optional[str] = None
    dtype: str = "bfloat16"
    device: str = "cpu"
    kernel_flops_per_step: Optional[float] = None
    # fold state: last (count, sum) seen on the timing histogram
    _last_count: int = field(default=0, repr=False)
    _last_sum: float = field(default=0.0, repr=False)
    last_row: Optional[dict] = field(default=None, repr=False)


class ProgramCostIndex:
    """Process-wide registry of per-program cost entries keyed by span
    path. Thread-safe; a count is taken once per (path, signature); fold
    runs off the hot loop. The span path is the identity, last writer
    wins, as in the reference."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, ProgramCost] = {}
        self._seen: set = set()
        self._train_path: Optional[str] = None

    # ------------------------------------------------------------ register
    def register(self, path: str, *, cost: Optional[CostCount] = None,
                 flops_per_step: Optional[float] = None,
                 bytes_per_step: Optional[float] = None,
                 peak_memory_bytes: Optional[float] = None,
                 steps_per_call: int = 1,
                 items_per_step: Optional[float] = None,
                 model_axis_size: int = 1,
                 timing_metric: Optional[str] = None,
                 source: Optional[str] = None, dtype=None,
                 device=None) -> Optional[ProgramCost]:
        """Register (or refresh — last write wins per path) one program's
        cost: a :class:`CostCount` of one step, or explicit
        ``flops_per_step``/``bytes_per_step`` (which override it).
        ``model_axis_size`` divides the flops/bytes (each card runs 1/m of
        a tensor-parallel program). Returns None when there is no cost."""
        kflops = None
        if cost is not None:
            if flops_per_step is None and cost.total_flops:
                flops_per_step = cost.total_flops
            if bytes_per_step is None and cost.total_bytes:
                bytes_per_step = cost.total_bytes
            kflops = cost.kernel_flops
            source = source or "counted"
        if flops_per_step is None and bytes_per_step is None:
            reg = get_registry()
            if reg.enabled:
                reg.counter("perf.cost_capture_failures").inc()
            return None
        m = max(1, int(model_axis_size))
        if m > 1:
            if flops_per_step is not None:
                flops_per_step /= m
            if bytes_per_step is not None:
                bytes_per_step /= m
        entry = ProgramCost(
            path=path, flops_per_step=flops_per_step,
            bytes_per_step=bytes_per_step,
            peak_memory_bytes=peak_memory_bytes,
            steps_per_call=max(1, int(steps_per_call)),
            items_per_step=items_per_step, model_axis_size=m,
            source=source or "analytic", timing_metric=timing_metric,
            dtype=_dtype_name(dtype), device=str(device or "cpu"),
            kernel_flops_per_step=kflops)
        with self._lock:
            prev = self._entries.get(path)
            if prev is not None:         # keep fold continuity on refresh
                entry._last_count = prev._last_count
                entry._last_sum = prev._last_sum
            self._entries[path] = entry
            if path.startswith("fit"):
                self._train_path = path
        return entry

    def count(self, path: str, sig, run: Callable[[], Any], *,
              steps_per_call: int = 1, timing_metric: Optional[str] = None,
              items_per_step: Optional[float] = None,
              model_axis_size: int = 1, dtype=None, device=None,
              registry: Optional[MetricsRegistry] = None):
        """Run ``run()`` and return its result; the first time ``(path,
        sig)`` is seen (with accounting and the registry on) the run is
        made under :func:`count_cost` and its count registered as ONE
        step's cost. ``sig``: a cheap shape signature of the program."""
        reg = registry or get_registry()
        key = (path, sig)
        if not (reg.enabled and accounting_enabled()) or key in self._seen:
            return run()
        with self._lock:
            if key in self._seen:
                fresh = False
            else:
                self._seen.add(key)
                fresh = True
        if not fresh:
            return run()
        with count_cost() as c:
            out = run()
        try:
            self.register(path, cost=c, steps_per_call=steps_per_call,
                          timing_metric=timing_metric,
                          items_per_step=items_per_step,
                          model_axis_size=model_axis_size, dtype=dtype,
                          device=device)
        except Exception as e:        # accounting must never break the loop
            log.debug("perf: cost registration failed for %s: %s", path, e)
        return out

    # ------------------------------------------------------------- queries
    def get(self, path: str) -> Optional[ProgramCost]:
        with self._lock:
            return self._entries.get(path)

    def paths(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def train_cost(self) -> Optional[ProgramCost]:
        """The most recently registered train-step program (path under
        ``fit``) — what PerformanceListener's mfu history keys read."""
        with self._lock:
            return (self._entries.get(self._train_path)
                    if self._train_path else None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._seen.clear()
            self._train_path = None

    # ---------------------------------------------------------------- fold
    def fold(self, registry: Optional[MetricsRegistry] = None
             ) -> List[dict]:
        """Resolve every entry against its timing histogram's NEW
        observations since the last fold and publish the
        ``perf.<path>.*`` gauges. Pure host arithmetic over metrics the
        hot loop already recorded — call from window/epoch boundaries,
        scrape handlers, or dump time, never from the dispatch loop.
        Returns the full cost table (entries without fresh timing keep
        their last row; entries without a timing metric report cost
        only)."""
        reg = registry or get_registry()
        rows: List[dict] = []
        if not accounting_enabled():
            return rows
        ceiling = max_plausible_mfu()
        # the whole fold runs under the index lock: concurrent folds
        # (epoch boundary vs /metrics scrape vs flight dump) must not
        # consume the same timing delta twice or tear _last_count/_sum.
        # Gauge/histogram accesses take their own (leaf) locks; nothing
        # acquires this lock while holding one of those.
        with self._lock:
            entries = list(self._entries.values())
            for e in entries:
                dt_step_ms = None
                if e.timing_metric:
                    h = reg.histogram_if_exists(e.timing_metric)
                    if h is not None:
                        count, total = h.count_and_sum()
                        if count < e._last_count:     # registry was reset:
                            e._last_count, e._last_sum = 0, 0.0   # resync
                        dc, ds = count - e._last_count, total - e._last_sum
                        if dc > 0 and ds >= 0:
                            e._last_count, e._last_sum = count, total
                            dt_step_ms = ds / dc / e.steps_per_call
                if dt_step_ms is None and e.last_row is not None:
                    rows.append(e.last_row)
                    continue
                rf = classify_roofline(e.flops_per_step, e.bytes_per_step,
                                       dtype=e.dtype, device=e.device)
                row = {"path": e.path, "flops_per_step": e.flops_per_step,
                       "bytes_per_step": e.bytes_per_step,
                       "peak_memory_bytes": e.peak_memory_bytes,
                       "steps_per_call": e.steps_per_call,
                       "items_per_step": e.items_per_step,
                       "model_axis_size": e.model_axis_size,
                       "source": e.source, "timing_metric": e.timing_metric,
                       "dtype": e.dtype, "device": e.device,
                       "kernel_flops_per_step": e.kernel_flops_per_step,
                       "roofline": rf["bound"], "intensity": rf["intensity"],
                       "attainable_tflops": rf["attainable_tflops"],
                       "step_ms": None, "achieved_tflops": None, "mfu": None,
                       "implausible": False}
                if dt_step_ms is not None and dt_step_ms > 0:
                    row["step_ms"] = dt_step_ms
                    peak = peak_tflops(dtype=e.dtype, device=e.device)
                    if e.flops_per_step:
                        achieved = e.flops_per_step / (dt_step_ms / 1e3) / 1e12
                        row["achieved_tflops"] = achieved
                    if e.flops_per_step and peak:
                        mfu = achieved / peak
                        # full precision: a small program's MFU would
                        # round to zero (renderers format)
                        row["mfu"] = mfu
                        # an MFU past the plausibility ceiling means the
                        # timing under-measured (async dispatch slack), not a
                        # fast chip — published, but flagged
                        row["implausible"] = mfu > ceiling
                    if reg.enabled:
                        p = f"perf.{e.path}"
                        reg.gauge(f"{p}.step_ms").set(round(dt_step_ms, 6))
                        if row["achieved_tflops"] is not None:
                            reg.gauge(f"{p}.achieved_tflops").set(
                                row["achieved_tflops"])
                        if row["mfu"] is not None:
                            reg.gauge(f"{p}.mfu").set(row["mfu"])
                            reg.gauge(f"{p}.implausible").set(
                                1.0 if row["implausible"] else 0.0)
                        reg.gauge(f"{p}.roofline_compute_bound").set(
                            1.0 if rf["bound"] == "compute" else 0.0)
                e.last_row = row
                rows.append(row)
        return rows


_index = ProgramCostIndex()
_index_lock = threading.Lock()


def get_cost_index() -> ProgramCostIndex:
    """THE process-wide cost index every capture site registers into."""
    return _index


def set_cost_index(index: ProgramCostIndex) -> ProgramCostIndex:
    global _index
    with _index_lock:
        prev, _index = _index, index
    return prev


# ----------------------------------------------------- step decomposition
class StepAccounting:
    """Per-step time decomposition with deferred flush.

    The fit loop calls :meth:`on_step` with host-measured millisecond
    walls (values it already computes — nothing here reads a device
    buffer); the samples buffer in plain lists and flush into
    ``<prefix>.compute_ms`` / ``input_wait_ms`` / ``host_ms`` histograms
    every ``flush_every`` steps and at epoch end — "why is steps/sec
    down" becomes answerable from ``/metrics``: a fat ``input_wait_ms``
    is the feed, a fat ``host_ms`` is listener/dispatch overhead, a fat
    ``compute_ms`` is the program itself (pair with ``perf.<path>.mfu``
    to see whether the program got slower or bigger)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "perf.step", flush_every: int = 32):
        self._registry = registry
        self.prefix = prefix
        self.flush_every = max(1, int(flush_every))
        self._buf: List[Tuple[float, float, float, int]] = []
        self._steps = 0

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else get_registry()

    def on_step(self, *, input_wait_ms: float, compute_ms: float,
                host_ms: float = 0.0, steps: int = 1) -> None:
        """Record one dispatch's wall decomposition (a K-window passes
        its TOTALS and ``steps=K``; flush divides)."""
        self._buf.append((input_wait_ms, compute_ms, host_ms, steps))
        self._steps += steps
        if self._steps >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        self._steps = 0
        reg = self.registry
        if not reg.enabled:
            return
        h_wait = reg.histogram(f"{self.prefix}.input_wait_ms")
        h_comp = reg.histogram(f"{self.prefix}.compute_ms")
        h_host = reg.histogram(f"{self.prefix}.host_ms")
        for wait, comp, host, k in buf:
            k = max(1, k)
            h_wait.observe(wait / k)
            h_comp.observe(comp / k)
            h_host.observe(max(host, 0.0) / k)


def decomposition_summary(registry: Optional[MetricsRegistry] = None
                          ) -> dict:
    """The step-time decomposition as one JSON-ready dict (perf.step.*
    histograms + the collective time the parallel layer publishes)."""
    reg = registry or get_registry()
    out: Dict[str, Any] = {}
    for part in ("compute_ms", "input_wait_ms", "host_ms"):
        h = reg.histogram_if_exists(f"perf.step.{part}")
        if h is not None and h.count:
            st = h.stats()
            out[part] = {"p50": round(st["p50"], 4),
                         "p95": round(st["p95"], 4),
                         "mean": round(st["mean"], 4),
                         "count": st["count"]}
    g = reg.gauge_if_exists("parallel.collective_ms")
    if g is not None:
        out["collective_ms"] = g.value
    means = {k: v["mean"] for k, v in out.items() if isinstance(v, dict)}
    total = sum(means.values())
    if total > 0:
        out["shares"] = {k: round(v / total, 4) for k, v in means.items()}
    return out


# --------------------------------------------------------------- baseline
class PerfBaseline:
    """The checked-in ``BENCH_r*.json`` trajectory as comparable rows.

    Real artifact files keep only the TAIL of the bench's stdout, so the
    final headline JSON line is often truncated mid-object; extraction
    is therefore per-row: for each known row name, find ``"<name>":`` in
    the tail and ``raw_decode`` the value that follows (a row cut off by
    the truncation is skipped, never guessed). ``best(name)`` returns
    the best value across the trajectory — the baseline the
    :class:`~.slo.ThroughputSLO` watchdog and ``tools/perf_report.py``
    compare against."""

    # row -> (sub-key inside a dict row, or None for scalar rows)
    KNOWN_ROWS: Dict[str, Optional[str]] = {
        "dispatch_bound_steps_per_sec": "k8_steps_per_sec",
        "serving_throughput": "bucketed_req_per_sec",
        "generate_tokens_per_sec": "continuous_tokens_per_sec",
        "transformer_lm_tokens_per_sec": None,
        "lstm_train_tokens_per_sec": None,
        "resnet50_amp_img_per_sec": None,
        "word2vec_words_per_sec": "words_per_sec",
    }

    def __init__(self, per_file: Dict[str, Dict[str, float]]):
        self.per_file = per_file          # file -> {row: value}

    @classmethod
    def load_trajectory(cls, root: str = ".",
                        pattern: str = "BENCH_r*.json") -> "PerfBaseline":
        import glob
        per_file: Dict[str, Dict[str, float]] = {}
        for path in sorted(glob.glob(os.path.join(root, pattern))):
            try:
                with open(path) as f:
                    artifact = json.load(f)
            except (OSError, ValueError):
                continue
            rows = cls._extract_rows(artifact)
            if rows:
                per_file[os.path.basename(path)] = rows
        return cls(per_file)

    @classmethod
    def _extract_rows(cls, artifact) -> Dict[str, float]:
        parsed = artifact.get("parsed") if isinstance(artifact, dict) \
            else None
        text = artifact.get("tail", "") if isinstance(artifact, dict) \
            else ""
        if isinstance(parsed, dict):
            text = json.dumps(parsed) + "\n" + text
        out: Dict[str, float] = {}
        dec = json.JSONDecoder()
        for name, sub in cls.KNOWN_ROWS.items():
            # LAST occurrence: the bench re-prints the result after every
            # row, so the final print carries the finished value
            idx = text.rfind(f'"{name}":')
            if idx < 0:
                continue
            rest = text[idx + len(name) + 3:].lstrip()
            try:
                val, end = dec.raw_decode(rest)
            except ValueError:
                continue                       # truncated mid-value
            if end >= len(rest):
                # the value ran to the very end of the (truncated) tail:
                # a number cut mid-digits still parses, so anything not
                # followed by more JSON is unverifiable — skip, never
                # guess
                continue
            if isinstance(val, dict):
                val = val.get(sub) if sub else val.get("value")
            if isinstance(val, (int, float)) and val > 0:
                out[name] = float(val)
        return out

    def best(self, name: str) -> Optional[float]:
        vals = [(rows.get(name), f) for f, rows in self.per_file.items()
                if rows.get(name)]
        return max(vals)[0] if vals else None

    def best_with_file(self, name: str) -> Tuple[Optional[float],
                                                 Optional[str]]:
        vals = [(rows[name], f) for f, rows in self.per_file.items()
                if rows.get(name)]
        return max(vals) if vals else (None, None)

    def rows(self) -> List[str]:
        names = set()
        for rows in self.per_file.values():
            names.update(rows)
        return sorted(names)


def baseline_deltas(baseline: "PerfBaseline",
                    registry: Optional[MetricsRegistry] = None
                    ) -> List[dict]:
    """Live gauge vs best-baseline rows for the rows that map onto live
    metrics ([] when neither side has data). The mapping is honest only
    when the live workload matches the bench row's — the regression
    watchdog exists for deployments that run the bench workloads (or
    operator-supplied baselines); the report labels the file the best
    value came from so a stale baseline is visible."""
    reg = registry or get_registry()
    live_map = {
        "dispatch_bound_steps_per_sec": "train.windowed_steps_per_sec",
        "generate_tokens_per_sec": None,      # resolved below (per-model)
    }
    out: List[dict] = []
    for row in baseline.rows():
        best, src = baseline.best_with_file(row)
        live = None
        metric = live_map.get(row)
        if metric:
            g = reg.gauge_if_exists(metric)
            live = g.value if g is not None and g.value else None
        elif row == "generate_tokens_per_sec":
            vals = [g.value for n, g in reg.gauges_matching(
                "generation.", ".tokens_per_sec") if g.value]
            live = max(vals) if vals else None
        rec = {"row": row, "baseline_best": best, "baseline_file": src,
               "live": round(live, 3) if live else None}
        if live and best:
            rec["ratio"] = round(live / best, 4)
        out.append(rec)
    return out


# -------------------------------------------------------------- snapshots
def perf_snapshot(registry: Optional[MetricsRegistry] = None,
                  index: Optional[ProgramCostIndex] = None,
                  top_k: int = 8, fresh_memory: bool = False) -> dict:
    """The ``"perf"`` block for ``/metrics``, the dashboard card and the
    flight recorder: cost table (freshly folded), step decomposition and
    the memory top-K. Never raises — an observability read must not add
    a second failure to whatever triggered it."""
    out: dict = {}
    try:                     # a malformed BENCH_PEAK_TFLOPS env value
        out["peak_tflops"] = peak_tflops()    # must not cost a flight
        out["hbm_gbps"] = hbm_gbps()          # dump its black box
    except (TypeError, ValueError) as e:
        log.debug("perf snapshot: bad chip-model env: %s", e)
    try:
        reg = registry or get_registry()
        idx = index or get_cost_index()
        out["programs"] = idx.fold(reg)
        out["step_decomposition"] = decomposition_summary(reg)
    except Exception as e:          # pragma: no cover - defensive
        log.debug("perf snapshot failed: %s", e)
    try:
        # the kernel library (ops/kernels/registry.py): registered kernels,
        # the implementation a call runs here, autotune decisions; a lazy
        # import, so telemetry never forces the ops package
        from ..ops.kernels import kernels_snapshot
        out["kernels"] = kernels_snapshot()
    except Exception as e:          # pragma: no cover - defensive
        log.debug("kernels snapshot failed: %s", e)
    try:
        # cached walk (~2 s max staleness) by default: /metrics scrapes
        # and repeat-fire dump triggers must not pay a fresh walk each.
        # ``fresh_memory=True`` forces it (write_perf_dump);
        # POST /debug/memprof calls memprof.snapshot directly.
        from . import memprof
        out["memory"] = (memprof.snapshot(top_k=top_k) if fresh_memory
                         else memprof.snapshot_cached(top_k=top_k))
    except Exception as e:          # pragma: no cover - defensive
        log.debug("memprof snapshot failed: %s", e)
    return out


def write_perf_dump(path: str, *,
                    registry: Optional[MetricsRegistry] = None,
                    index: Optional[ProgramCostIndex] = None,
                    baseline_root: Optional[str] = None,
                    top_k: int = 10) -> str:
    """Write the offline-report input file: folded cost table, step
    decomposition, memory profile, full metrics snapshot and (when
    ``baseline_root`` holds ``BENCH_r*.json`` files) baseline deltas.
    ``tools/perf_report.py`` renders it; a flight-recorder dump is an
    acceptable substitute (it carries the same ``perf`` block)."""
    reg = registry or get_registry()
    idx = index or get_cost_index()
    record = {"perf_dump": 1, "wall_time": time.time(),
              "perf": perf_snapshot(reg, idx, top_k=top_k,
                                    fresh_memory=True),
              "metrics": reg.snapshot()}
    if baseline_root is not None:
        baseline = PerfBaseline.load_trajectory(baseline_root)
        record["baseline"] = {"files": baseline.per_file,
                              "deltas": baseline_deltas(baseline, reg)}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, default=repr)
    os.replace(tmp, path)
    return path
