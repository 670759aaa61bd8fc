"""StatsListener: per-iteration training statistics -> StatsStorage.

Counterpart of ``deeplearning4j_tpu/ui/stats.py``: ``StatsUpdateConfiguration``
and ``StatsListener`` (score, timing, memory, parameter / update /
activation statistics and histograms keyed by session and worker, the
records and their keys the reference's), in torch idiom:

- **One device-to-host read a report.** Every statistic a report holds
  (the score, each parameter's moments and histogram, each update's, each
  activation's mean magnitude) is computed on the network's device, the
  pieces are joined into one float64 vector and read with one ``.cpu()``;
  the reference needs up to three jitted programs and reads
  (``stats.py:120-190``).
- **All leaves at once.** The parameters are joined into one float32
  vector and each statistic is one segment reduction over it
  (``_Segments``: sums in float64, where the reference sums each leaf in
  float32), so a report launches a few dozen kernels whatever the number
  of leaves (a loop over leaves launched ~60 a leaf, and their dispatch
  on the host took 3.4-3.9x the char-RNN's training step on an H100,
  PERF.md). The joined
  vector is also the next report's update snapshot: a copy, as a window's
  CUDA graph updates the parameters in place
  (``optimize/step_graph.py``), and a snapshot that aliased them would
  read every update as 0.
- **Population standard deviation** (``correction=0``), as ``jnp.std``.
- **Histograms follow ``jnp.histogram``** (numpy's rule): edges from
  ``linspace(min, max, bins + 1)`` in float32, as XLA computes them
  (``_edges``), bin i holding ``edges[i] <= x < edges[i + 1]``, the last
  bin closed; a constant leaf gets the range ``[v - 0.5, v + 0.5]``.
  Counts are written as floats, as the reference writes its float32
  counts.
- **Leaf names** are the reference's ``_named_leaves`` (``:50-67``): the
  pytree path with dict keys sorted, ``0/W`` for a ``MultiLayerNetwork``,
  ``<vertex>/W`` for a ``ComputationGraph``.
- Activation statistics come from ``model.feed_forward(sample)`` (no
  gradient): a ``MultiLayerNetwork``'s layer outputs as ``layer_<i>``, as
  the reference's ``apply_fn`` outputs; a ``ComputationGraph``'s
  vertices by name (the reference's graph path fails on its dict).
- The static record names the network's device: ``backend`` ``cuda`` with
  the card's name and the device count, or ``cpu``. Memory is
  ``torch.cuda.memory_allocated`` and the card's total on a card, the
  host's RSS everywhere.

The listener joins the fan-out every listener gets from ``Solver`` and
``ParallelWrapper`` (``optimize/solver.py`` ``notify_batch`` /
``notify_window``): a report in a window sees the window's parameters
after its last step, as the reference's does.
"""
from __future__ import annotations

import os
import socket
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optimize.listeners import TrainingListener
from .storage import InMemoryStatsStorage, StatsStorage

# a record's keys in the reference's order (its host copy of a dict of
# arrays comes back with the keys sorted)
_MOMENTS = ("max", "mean", "meanmag", "min", "stdev")
_UPDATE = ("mean", "meanmag", "stdev")


@dataclass
class StatsUpdateConfiguration:
    """What to collect, how often (reference StatsUpdateConfiguration /
    DefaultStatsUpdateConfiguration)."""
    report_frequency: int = 1
    collect_score: bool = True
    collect_timing: bool = True
    collect_memory: bool = True
    collect_param_stats: bool = True
    collect_update_stats: bool = True
    collect_activation_stats: bool = False
    collect_histograms: bool = False
    histogram_bins: int = 20
    collect_learning_rates: bool = True


def named_leaves(tree) -> List[Tuple[str, Any]]:
    """Flatten a nest of dicts, lists and tuples into [(name, leaf)] with
    the reference's names and order (``jax.tree_util`` paths joined by
    "/", dict keys sorted): ``net.param_dicts()`` gives ``0/W`` ... for a
    ``MultiLayerNetwork`` and ``conv1/b`` ... for a graph."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [str(i)], v)
        else:
            out.append(("/".join(prefix), node))

    walk([], tree)
    return out


class _Segments:
    """Tensors of fixed sizes laid end to end: ``flat`` joins them into
    one float32 vector, ``seg`` names each element's tensor, and the
    per-tensor reductions below are a few kernels for any number of
    tensors. A loop over the tensors would launch ~60 small kernels a
    tensor, whose dispatch on the host costs more than the char-RNN's
    training step; an ``index_add_`` into one slot a tensor would make
    millions of atomic adds wait on a few addresses. So sums are
    differences of a float64 prefix sum at the tensors' ends, counts a
    ``histc`` of integer keys, and only min and max take one reduction a
    tensor."""

    def __init__(self, sizes: Tuple[int, ...], device: torch.device):
        self.sizes = sizes
        self.count = len(sizes)
        counts = torch.tensor(sizes, device=device)
        self.n = counts.double()
        self.ends = torch.cumsum(counts, 0) - 1
        self.seg = torch.repeat_interleave(
            torch.arange(self.count, device=device), counts,
            output_size=sum(sizes))

    @staticmethod
    def flat(tensors) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    def sums(self, x64: torch.Tensor) -> torch.Tensor:
        at_ends = torch.cumsum(x64, 0)[self.ends]
        return torch.diff(at_ends, prepend=at_ends.new_zeros(1))

    def moments(self, x: torch.Tensor, names=_MOMENTS) -> torch.Tensor:
        """[tensors, len(names)] float64 of the flat float32 ``x``: of
        "max", "mean", "meanmag", "min", "stdev" (population), summed in
        float64."""
        x64 = x.double()
        cols = {"mean": self.sums(x64) / self.n,
                "meanmag": self.sums(x64.abs()) / self.n}
        if "stdev" in names:
            d = x64 - cols["mean"][self.seg]
            cols["stdev"] = (self.sums(d * d) / self.n).sqrt()
        if "max" in names:
            mn, mx = zip(*(torch.aminmax(v) for v in x.split(self.sizes)))
            cols["max"] = torch.stack(mx).double()
            cols["min"] = torch.stack(mn).double()
        return torch.stack([cols[k] for k in names], dim=1)

    def histograms(self, x: torch.Tensor, mn: torch.Tensor,
                   mx: torch.Tensor, bins: int) -> torch.Tensor:
        """[tensors, 2 + bins] float64: lo, hi and the counts of each
        tensor's ``jnp.histogram`` (edges from ``_edges``, bin i holding
        ``edges[i] <= x < edges[i + 1]``, the last bin closed; a constant
        tensor's range ``[v - 0.5, v + 0.5]``). A bin is guessed from the
        value's place in its range and moved to the one whose edges hold
        it; the guess is off by at most a bin where an edge rounds."""
        flat = mn == mx
        lo = torch.where(flat, mn - 0.5, mn)
        hi = torch.where(flat, mx + 0.5, mx)
        edges = _edges(lo, hi, bins).reshape(-1)
        base = self.seg * (bins + 1)
        b = ((x - lo[self.seg]) / (hi - lo)[self.seg] * bins).floor()
        b = b.clamp_(0, bins - 1).long()
        for _ in range(2):
            b = b - (x < edges[base + b]).long()
            b = b + ((x >= edges[base + b + 1]) & (b < bins - 1)).long()
        # integer keys in [0, tensors * bins): histc's unit bins count them
        # exactly (float counts, exact below 2^24 a bin)
        keys = (self.seg * bins + b).float()
        n_keys = self.count * bins
        counts = torch.histc(keys, bins=n_keys, min=0, max=n_keys)
        return torch.cat([torch.stack([lo, hi], dim=1).double(),
                          counts.double().reshape(self.count, bins)], dim=1)


def _edges(lo: torch.Tensor, hi: torch.Tensor, bins: int) -> torch.Tensor:
    """[tensors, bins + 1] float32 edges: ``jnp.linspace(lo, hi, bins +
    1)`` as XLA's CPU backend computes it (the reference's numbers): the
    division by ``bins`` turned into a product with its float32
    reciprocal r, and edge i a fused multiply-add ``fma(i, f32(hi·r),
    f32(lo·(1 - f32(i·r))))`` (edge 1 ``fma(lo, 1 - r, f32(hi·r))``),
    emulated in float64, where those products are exact. numpy's own
    edges differ in the last bit, and a constant leaf's value sits on its
    middle edge: this puts it in the reference's bin."""
    f32, f64 = torch.float32, torch.float64
    r = float(np.float32(1.0) / np.float32(bins))
    i = torch.arange(bins, dtype=f64, device=lo.device)
    a = lo.double()[:, None] * (1.0 - (i * r).to(f32)).to(f32).double()
    br = (hi.double() * r).to(f32).double()[:, None]
    e = i * br + a.to(f32).double()
    if bins > 1:
        e[:, 1] = a[:, 1] + br[:, 0]
    return torch.cat([e.to(f32), hi[:, None]], dim=1)


class StatsListener(TrainingListener):
    """Collects training stats into a StatsStorage every `report_frequency`
    iterations. Attach with `net.set_listeners(StatsListener(storage))`, then
    render with `deeplearning4j_tpu_torch.ui.render_dashboard(storage,
    path=...)` or serve live with `TrainingUIServer`.
    """

    def __init__(self, storage: Optional[StatsStorage] = None,
                 config: Optional[StatsUpdateConfiguration] = None,
                 session_id: Optional[str] = None,
                 worker_id: str = "worker_0",
                 activation_sample=None):
        self.storage = storage if storage is not None else InMemoryStatsStorage()
        self.config = config or StatsUpdateConfiguration()
        self.session_id = session_id or uuid.uuid4().hex[:12]
        self.worker_id = worker_id
        # Optional sample batch: when collect_activation_stats is on, a
        # forward over it gives each layer's activation mean magnitude (the
        # training step's intermediates are not kept).
        self.activation_sample = activation_sample
        self._sample = None
        self._static_posted = False
        self._layouts: Dict[str, _Segments] = {}
        # the parameters as one float32 vector at the last report: a copy
        # (``torch.cat``), as a window's CUDA graph updates them in place
        self._prev_snapshot: Optional[torch.Tensor] = None
        self._prev_snapshot_iter = None
        self._last_report_time = None
        self._iters_since_report = 0

    # ---------------------------------------------------------------- helpers
    def _segments(self, sizes, device, key: str) -> _Segments:
        """The cached layout of ``sizes`` (parameters or activations)."""
        segs = self._layouts.get(key)
        if segs is None or segs.sizes != sizes:
            segs = self._layouts[key] = _Segments(sizes, device)
        return segs

    def _activations(self, model) -> Optional[List[Tuple[str, torch.Tensor]]]:
        if self.activation_sample is None or \
                not hasattr(model, "feed_forward"):
            return None
        if self._sample is None:
            self._sample = model._as_input(self.activation_sample)
        with torch.no_grad():
            acts = model.feed_forward(self._sample)
        if isinstance(acts, dict):
            inputs = set(model.conf.network_inputs)
            return [(n, a) for n, a in acts.items() if n not in inputs]
        return [(f"layer_{i}", a) for i, a in enumerate(acts[1:])]

    @staticmethod
    def _memory_stats(model) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        try:
            import resource
        except ImportError:   # non-POSIX platform
            pass
        else:
            out["host_rss_mb"] = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
        dev = getattr(model, "device", None)
        if dev is not None and dev.type == "cuda":
            out["device_bytes_in_use"] = int(torch.cuda.memory_allocated(dev))
            out["device_bytes_limit"] = int(
                torch.cuda.get_device_properties(dev).total_memory)
        return out

    def _post_static(self, model):
        dev = getattr(model, "device", torch.device("cpu"))
        cuda = dev.type == "cuda"
        info = {
            "model_class": type(model).__name__,
            "num_params": int(getattr(model, "num_params", lambda: 0)()),
            "backend": dev.type,
            "device_kind": torch.cuda.get_device_name(dev) if cuda
            else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            "start_time": time.time(),
            "param_names": [n for n, _ in named_leaves(model.param_dicts())],
        }
        # config JSON powers the dashboard's model-graph view (reference
        # TrainModule model tab renders from the stored config)
        conf = getattr(model, "conf", None)
        if conf is not None and hasattr(conf, "to_json"):
            info["model_config_json"] = conf.to_json()
        self.storage.put_static_info(self.session_id, self.worker_id, info)
        self._static_posted = True

    def _learning_rates(self, model, iteration) -> Dict[str, float]:
        upd = getattr(model, "updater", None)
        lrs: Dict[str, float] = {}
        if upd is None or not hasattr(upd, "layer_confs"):
            return lrs
        for i, c in enumerate(upd.layer_confs.values()):
            rule = upd.rule_for(c)
            # rules without a schedule surface (e.g. NoOp) are skipped;
            # a broken schedule raising inside lr() must propagate
            if hasattr(rule, "lr"):
                lrs[str(i)] = float(rule.lr(iteration))
        return lrs

    # ----------------------------------------------------------- listener API
    def iteration_done(self, model, iteration: int, score):
        if not self._static_posted:
            self._post_static(model)
        self._iters_since_report += 1
        if iteration % self.config.report_frequency != 0:
            return
        cfg = self.config
        now = time.time()
        update: Dict[str, Any] = {"iteration": int(iteration), "timestamp": now}
        device = getattr(model, "device", torch.device("cpu"))
        pairs = named_leaves(model.param_dicts())
        names = [n for n, _ in pairs]
        bins = cfg.histogram_bins
        if pairs:
            segs = self._segments(tuple(p.numel() for _, p in pairs), device,
                                  "params")
            flat = _Segments.flat([p for _, p in pairs])
        parts: List[torch.Tensor] = []          # read back in this order
        if cfg.collect_score:
            s_ = score if isinstance(score, torch.Tensor) \
                else torch.tensor(float(score))
            parts.append(s_.detach().reshape(1).to(device, torch.float64))
        if cfg.collect_param_stats and pairs:
            stats = segs.moments(flat)
            parts.append(stats)
            if cfg.collect_histograms:
                parts.append(segs.histograms(flat, stats[:, 3].float(),
                                             stats[:, 0].float(), bins))
        has_updates = cfg.collect_update_stats and bool(pairs) and \
            self._prev_snapshot is not None and \
            self._prev_snapshot.shape == flat.shape
        if has_updates:
            # the per-iteration update scale the reference reports from
            # updater output (BaseStatsListener.java:383-394)
            iters = float(max(iteration - self._prev_snapshot_iter, 1))
            parts.append(segs.moments((flat - self._prev_snapshot) / iters,
                                      _UPDATE))
        acts = self._activations(model) if cfg.collect_activation_stats \
            else None
        if acts is not None:
            asegs = self._segments(tuple(a.numel() for _, a in acts),
                                   device, "activations")
            a64 = _Segments.flat([a for _, a in acts]).double().abs()
            parts.append(asegs.sums(a64) / asegs.n)
        # the report's one host read
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().tolist() \
            if parts else []
        at = 0

        def take(n):
            nonlocal at
            at += n
            return host[at - n:at]

        if cfg.collect_score:
            update["score"] = take(1)[0]
        if cfg.collect_timing and self._last_report_time is not None:
            dt = max(now - self._last_report_time, 1e-9)
            update["iterations_per_sec"] = self._iters_since_report / dt
            update["ms_per_iteration"] = 1000.0 * dt / self._iters_since_report
        if cfg.collect_memory:
            update["memory"] = self._memory_stats(model)
        if cfg.collect_param_stats and pairs:
            rows = [dict(zip(_MOMENTS, take(len(_MOMENTS)))) for _ in names]
            if cfg.collect_histograms:
                for rec in rows:
                    lo, hi, *counts = take(bins + 2)
                    rec["histogram"] = {"counts": counts, "lo": lo, "hi": hi}
            update["params"] = dict(zip(names, rows))
        if cfg.collect_update_stats:
            if has_updates:
                update["updates"] = {
                    n: dict(zip(_UPDATE, take(len(_UPDATE)))) for n in names}
            self._prev_snapshot = flat if pairs else None
            self._prev_snapshot_iter = iteration
        if acts is not None:
            update["activations"] = {n: v for (n, _), v in
                                     zip(acts, take(len(acts)))}
        if cfg.collect_learning_rates:
            lrs = self._learning_rates(model, iteration)
            if lrs:
                update["learning_rates"] = lrs
        self.storage.put_update(self.session_id, self.worker_id, update)
        self._last_report_time = now
        self._iters_since_report = 0
