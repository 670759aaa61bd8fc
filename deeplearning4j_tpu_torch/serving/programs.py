"""Warmed forward programs: one model version's forward, run once per bucket
before traffic.

Counterpart of ``deeplearning4j_tpu/serving/programs.py`` (``:62-192``).
The reference lowers and compiles one XLA executable per rung at warm-up so
the serving path never traces. The port runs eagerly, so there is nothing
to compile: ``warm()`` runs every rung once on the network's device, which
builds the CUDA kernels, loads the libraries and lets cuDNN pick its
algorithms for those shapes before the first request; ``run`` refuses a
bucket that was not warmed, as the reference refuses one with no
executable. A CUDA graph per bucket (ROADMAP A2) is later work. Each warm
run is noted to ``telemetry.note_warm_run`` and, with ``cost_path`` set
(the engine's ``serving.<model>``), is counted (``telemetry.perf``
``ProgramCostIndex.count``: the aten ops' formulas and the kernels' own
counts) into the ``<cost_path>.bucket<b>`` cost entry, paired with the
batcher's ``<cost_path>.bucket<b>.dispatch_ms`` histogram, as the
reference registers each bucket's executable (``:78, 138-155``). The
entry folds against the peak of the network's compute dtype.

A ``forward_fn`` is called as ``forward_fn(net, x)`` with the set's own
network and the padded batch as a tensor on its device, and returns the
output tensor. The reference's form is ``(params, state, x)``; a port
network keeps its parameters in its modules, so the set hands over the
network itself, and a set built by ``with_params_from`` (a same-shape hot
swap) runs the new network through the same ``forward_fn``. Sets are
immutable after ``warm()``: the engine swaps whole sets, and a batch in
flight keeps the set it took at dispatch.

``default_forward`` keeps the reference's behaviour for a
``ComputationGraph``: ``_output_pure`` returns the list of outputs, so the
result gains a leading axis of length 1 and the batcher slices the wrong
axis (ROADMAP §C). Serve a graph with a ``forward_fn`` that returns its
one output, as the GoogLeNet path does.

**Mesh-sharded serving** (``mesh=``, reference ``:82-120``): the merged
batch lands on the mesh's data axis. The ladder must divide over it
(``BucketLadder.validate_for_mesh``); the padded batch is cut into the
workers' rows (``data_sharding(mesh, data_axis).split``), each worker's
rows go through the forward in worker order, and the outputs are joined.
The parameters are the network's, which every worker reads (replicated).
"""
from __future__ import annotations

from typing import Callable, Optional, Set, Tuple

import numpy as np
import torch

from ..parallel.mesh import data_sharding
from .buckets import BucketLadder
from .errors import ServingError
from ..telemetry.perf import get_cost_index
from ..telemetry.torchsignals import timed_warm_run


def _describe(module) -> Tuple:
    """A layer or vertex by type and hyperparameters (its public
    attributes; parameters live in ``_parameters`` and are not among
    them), with a vertex's layer inside. A list reads as a tuple: a
    configuration read from JSON holds ``[3, 3]`` where a built one holds
    ``(3, 3)``."""
    attrs = tuple(sorted((k, repr(tuple(v) if isinstance(v, list) else v))
                         for k, v in vars(module).items()
                         if not k.startswith("_") and k != "training"))
    layer = getattr(module, "layer", None)
    return (type(module).__name__, attrs,
            _describe(layer) if layer is not None else None)


def _arch_key(net) -> Tuple:
    """Architecture identity beyond shapes: the layers' and vertices' types
    and hyperparameters and the graph's wiring, without the seed (two
    same-shaped nets can differ in activation or layer type, and running
    one's warmed set for the other is fine only when they do not; the
    reference compares the configuration's JSON minus the seed)."""
    conf = net.conf
    if hasattr(conf, "vertex_names"):
        return ("graph", tuple(conf.network_inputs),
                tuple(conf.network_outputs),
                tuple((n, tuple(conf.vertex_inputs[n]),
                       _describe(net.vertices[n])) for n in conf.vertex_names))
    return ("multilayer", tuple(_describe(layer) for layer in net.layers))


def _param_signature(net) -> Tuple:
    return (str(net.device),
            tuple((n, tuple(p.shape), str(p.dtype))
                  for n, p in net.named_parameters()))


def default_forward(net) -> Callable:
    """(net, x) -> the network's output in inference mode: the reference's
    ``default_forward`` over ``_output_pure``."""
    def fwd(net_, x):
        return net_._output_pure(x, train=False)
    return fwd


def _to_numpy(out) -> np.ndarray:
    if isinstance(out, (list, tuple)):     # a graph's list of outputs
        return np.asarray([_to_numpy(o) for o in out])
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.detach().cpu().numpy()


class ProgramSet:
    """One model version's forward, the network it runs and the buckets it
    has warmed."""

    def __init__(self, net, *, feature_shape: Tuple[int, ...],
                 ladder: BucketLadder, dtype="float32", mesh=None,
                 data_axis: str = "data",
                 forward_fn: Optional[Callable] = None,
                 trace_hook: Optional[Callable[[], None]] = None,
                 cost_path: Optional[str] = None):
        self.net = net
        self.cost_path = cost_path
        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is not None:
            if mesh.device != net.device:
                raise ValueError(f"the mesh lives on {mesh.device}, the "
                                 f"network on {net.device}")
            ladder.validate_for_mesh(mesh, data_axis)
        self.feature_shape = tuple(int(d) for d in feature_shape)
        self.ladder = ladder
        self.dtype = np.dtype(dtype)
        self._custom_fwd = forward_fn
        self._fwd = forward_fn or default_forward(net)
        self._trace_hook = trace_hook
        self._warmed: Set[int] = set()
        self.signature = (_param_signature(net), _arch_key(net),
                          self.feature_shape, str(self.dtype),
                          self.ladder.rungs, None if mesh is None else (
                              mesh.axis_names, mesh.axis_sizes, data_axis))

    # ---------------------------------------------------------------- warm-up
    def warm(self) -> "ProgramSet":
        """Run every rung once on zeros, on the network's device. Called
        when a model is added and before a swap that changed shapes or
        architecture, never on the request path."""
        for b in self.ladder:
            if self._trace_hook is not None:
                self._trace_hook()          # counts warm runs
            pad = np.zeros((b,) + self.feature_shape, self.dtype)
            with timed_warm_run():
                if self.cost_path is None:
                    self._execute(pad)
                else:
                    self._count(b, pad)
            self._warmed.add(b)
        return self

    def _count(self, b: int, pad: np.ndarray) -> None:
        """Bucket ``b``'s warm run, counted into its cost entry."""
        net = self.net
        get_cost_index().count(
            f"{self.cost_path}.bucket{b}", (b,) + self.signature,
            lambda: self._execute(pad), items_per_step=float(b),
            timing_metric=f"{self.cost_path}.bucket{b}.dispatch_ms",
            dtype=getattr(net.conf, "compute_dtype", None) or net.dtype,
            device=net.device)

    @property
    def warmed(self) -> bool:
        return self._warmed >= set(self.ladder.rungs)

    # ---------------------------------------------------------------- serving
    def _execute(self, padded: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(padded, device=self.net.device)
        if x.is_floating_point():
            x = x.to(self.net.dtype)
        with torch.inference_mode():
            if self.mesh is None:
                return _to_numpy(self._fwd(self.net, x))
            # each data worker's rows in worker order, then joined
            sh = data_sharding(self.mesh, self.data_axis)
            return _to_numpy(sh.gather(torch.stack(
                [self._fwd(self.net, rows) for rows in sh.split(x)])))

    def run(self, padded: np.ndarray) -> np.ndarray:
        """Run the forward on ``padded.shape[0]`` rows, a warmed bucket,
        and return the result on the host."""
        b = padded.shape[0]
        if b not in self._warmed:
            raise ServingError(
                f"no warmed program for bucket {b} (warmed: "
                f"{sorted(self._warmed)}) — call warm()/warm_up() before "
                "serving")
        return self._execute(padded)

    def with_params_from(self, net) -> "ProgramSet":
        """Hot-swap fast path: same architecture and parameter shapes (equal
        signatures) -> a new set that shares this set's warmed buckets and
        runs ``net``. Raises ValueError otherwise (the caller warms a fresh
        set)."""
        new = ProgramSet(net, feature_shape=self.feature_shape,
                         ladder=self.ladder, dtype=self.dtype,
                         mesh=self.mesh, data_axis=self.data_axis,
                         forward_fn=self._custom_fwd,
                         trace_hook=self._trace_hook,
                         cost_path=self.cost_path)
        if new.signature != self.signature:
            raise ValueError("parameter shapes or architecture changed; full "
                             "warm-up required")
        new._warmed = self._warmed      # shared: warmed per shape, not net
        return new
