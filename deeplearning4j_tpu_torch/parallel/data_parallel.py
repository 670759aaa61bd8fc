"""Data-parallel training: ``ParallelWrapper`` on a logical mesh.

Counterpart of ``deeplearning4j_tpu/parallel/data_parallel.py``
``ParallelWrapper`` (``:52``): the constructor's arguments and refusals
(``:107-257``), the sync paths (``:308-560``), the accumulator step
(``:562-601``), K-step averaging (``_build_avg_step`` / ``_run_avg``,
``:604-656, 882-911``), ``gather_opt_state`` (``:446-454``) and ``fit`` /
``_fit_epoch`` / ``_notify`` (``:659-920``).

It wraps a ``MultiLayerNetwork`` or a ``ComputationGraph``. The workers are
the rows of ``parallel/mesh.py``'s logical mesh on one device: their
forward and backward passes run one after the other, each drawing dropout
from its own generator, all seeded alike, as the reference's replicated
key gives them the same numbers on their shards.

- **The sync step** (``_step_math``): each worker's loss and gradient on
  its shard, then one of:
  - the plain mean over the workers (``pmean``; the reference's GSPMD
    all-reduce, ``:308-327``);
  - ``overlap_sync``: the mean a bucket at a time (``overlap.py``
    ``bucketed_pmean``, ``:375-434``), bitwise the plain mean;
  - ``zero_stage=1|2``: the ZeRO update (``zero.py``, ``:456-527``): the
    gradient reduced into shards, the updater on each worker's shard, the
    parameters gathered; ``net.opt_state`` is in the engine's sharded
    format for as long (``gather_opt_state()`` gives the per-layer format
    back). Bitwise the plain update;
  - a ``gradient_accumulator``'s ``combine`` (the flat gradient in
    ``ravel_pytree``'s order; its carry ``_acc_state`` is
    ``[n, num_params]``).

  One updater step follows on the combined gradient and the loss is the
  workers' mean. A batch that does not tile the mesh takes one step on the
  whole batch (the reference's replicated-feed program, ``:529-559``; the
  same update); the accumulator path keeps the reference's loud error
  there (its carry is per worker).
- **Layer state** (a BatchNormalization's running statistics) follows the
  reference's programs. In its ``shard_map`` steps each worker normalizes
  by its own shard's statistics and the new states are averaged with the
  loss (``fused_pmean``): here each worker's forward records its new state
  without writing it (``nn/tape.py``) and the states are averaged in
  worker order and written once. The plain sync step is one GSPMD program
  over the global batch there, so its batch statistics are the whole
  batch's: a network with layer state takes that step on the whole batch
  here, as the remainder batch does.
- **Windows** (``steps_per_dispatch=K``, every sync path but the
  accumulator's): ``iter_windows`` groups K same-shape batches; on the
  card the wrapper's step is captured once per key into a CUDA graph
  (``optimize/step_graph.py``'s ``WindowGraphs``, which runs ``Solver``'s
  windows too) and replayed a batch, with the iteration tensor filled
  and the workers' generators reseeded before each replay; on the CPU
  the steps run eagerly. A ragged window runs per step. Either way a window equals its
  K steps. ``graph_stats()`` counts captures, replays and the kernels'
  launches in replays.
- **K-step averaging** (``training_mode="averaging"``,
  ``averaging_frequency=K > 1``): each worker runs K local steps on its
  shard of K batches from the same start, then the parameters, layer state
  and (``average_updaters``) updater state are averaged (``_run_avg``).
- **Listeners and callbacks**: the epoch hooks, ``note_window`` /
  ``note_batch`` (the wait from the ``DevicePrefetchIterator``) and
  ``iteration_done`` through ``Solver``'s ``notify_window`` /
  ``notify_batch`` (``optimize/solver.py``), and
  ``step_callback(net, k)`` after each dispatched item's k iterations are
  counted (the reference's seam for elastic supervision and asynchronous
  checkpoints).
- **Telemetry** (reference ``:369-371, 728-744, 757-904``): the ``fit`` /
  ``epoch`` / ``window`` / ``dispatch`` / ``step`` spans, the
  ``train.iterations`` and ``train.windows`` counters,
  ``parallel.collective_launches`` (the collectives a step's sync runs on
  the mesh: a bucket's reduction each, ZeRO's all-gathers, and the fused
  state and loss mean; counted on the host per dispatched step, as the
  reference counts them), the ``parallel.bucket_count`` gauge when the
  schedule is built and, on a model axis, ``parallel.model_axis``,
  ``parallel.param_bytes_per_replica`` and
  ``parallel.opt_bytes_per_replica`` after the fit. A window's spans wrap
  its replays on the host; nothing is recorded inside the captured step.

Feeds run through a ``DevicePrefetchIterator`` of ``prefetch_buffer``
batches (0 feeds batches as they come) on every path; the reference's
averaging path keeps a host-side prefetcher instead, since it stacks host
batches. ``skip_first_batches`` consumes the first batches of the first
epoch without training them (the mid-epoch resume, reference
``:659-760``).

**Over processes** (a mesh from ``distributed.global_mesh``, one worker a
process): every path of the data axis runs, each process computing its own
worker's row and the collectives crossing the group (``parallel/mesh.py``):
plain sync, ``overlap_sync``, ZeRO (each process holds its shard row of
the updater state), a ``GradientsAccumulator`` (its carry is the
process's own row; the encoded one ships its payload) and K-step
averaging (the means over the processes). Each gives the logical mesh's
bits. A model axis over processes is refused (ROADMAP A7b-4b).

**A model axis** (``mesh_shape=(d, m)`` or a mesh with a ``model`` axis,
reference ``:126-173, 259-360``): on entry to ``fit`` the network's
parameters and updater state are laid out by ``tensor_parallel``'s rules
(``place_net``): a leaf the rules shard becomes its m per-rank rows, and
every forward runs the layers' Megatron path over them. The data axis
works as on a 1-D mesh (the feed cut over its d workers, ``pmean``, ZeRO
over it, windows, ``overlap_sync``); K-step averaging and a
``GradientsAccumulator`` are refused with the reference's messages. At
m = 1 the spec table is empty and nothing is laid out, so ``(d, 1)`` is
bitwise ``(d,)``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..datasets.prefetch import (BatchWindow, DevicePrefetchIterator,
                                 iter_windows, skip_batches)
from ..nn.tape import collect_state, commit_state
from ..optimize.solver import (EtlClock, cast_feed, epoch_hook,
                               notify_batch, notify_window, train_step_math)
from ..optimize.step_graph import WindowGraphs
from ..telemetry import get_registry, span
from .mesh import (Mesh, axis_size, data_sharding, local_count, make_mesh,
                   pmean)
from .overlap import (DEFAULT_BUCKET_BYTES, bucketed_pmean,
                      build_bucket_schedule)
from .tensor_parallel import (MODEL_AXIS, model_axis_size,
                              per_replica_bytes, place_net, tree_specs)
from .zero import ZeroUpdateEngine, is_zero_state


def flat_param_order(net) -> List[Tuple[object, str, torch.nn.Parameter]]:
    """(group, name, parameter) for every parameter of ``net`` in the order
    the reference's ``ravel_pytree(grads)`` flattens them: vertices (or
    layers) in the network's order, each one's names sorted."""
    return [(group, name, pd[name])
            for group, pd in net.param_dicts().items()
            for name in sorted(pd)]


def flat_opt_state_order(net) -> List[Tuple[object, str, str,
                                             torch.Tensor]]:
    """(group, parameter name, state name, tensor) for the updater state
    of ``net`` in ``jax.tree.leaves(opt_state)``'s order: the parameters
    in ``flat_param_order``, each one's state names sorted (Adam:
    ``W.m, W.v, b.m, b.v``). A rule without state (``Sgd``) gives none."""
    state = net.opt_state
    return [(group, name, sname, state[group][name][sname])
            for group, name, _ in flat_param_order(net)
            for sname in sorted(state[group][name])]


class ParallelWrapper:
    """API analogue of the reference ``ParallelWrapper``:

        pw = ParallelWrapper(net, mesh=make_mesh((4,)),
                             gradient_accumulator=EncodedAccumulator(1e-3))
        pw.fit(iterator, epochs=2)

    The worker count comes from the mesh's ``data`` axis; ``workers=n``
    builds a mesh of n logical workers on the network's device when no mesh
    is given."""

    def __init__(self, net, *, mesh: Optional[Mesh] = None,
                 mesh_shape: Optional[tuple] = None,
                 workers: Optional[int] = None,
                 averaging_frequency: int = 1,
                 training_mode: str = "shared_gradients",
                 average_updaters: bool = True, prefetch_buffer: int = 2,
                 report_score_after_averaging: bool = True,
                 gradient_accumulator=None, steps_per_dispatch: int = 1,
                 overlap_sync: bool = False,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 zero_stage: int = 0, step_callback=None):
        self.net = net
        if mesh is not None and mesh_shape is not None:
            raise ValueError("pass mesh OR mesh_shape, not both")
        if workers is not None and mesh is None and mesh_shape is None:
            mesh = make_mesh((int(workers),), ("data",), net.device)
        if mesh_shape is not None:
            if len(mesh_shape) == 1:
                mesh = make_mesh(tuple(mesh_shape), ("data",), net.device)
            elif len(mesh_shape) == 2:
                mesh = make_mesh(tuple(mesh_shape), ("data", MODEL_AXIS),
                                 net.device)
            else:
                raise ValueError(f"mesh_shape must be (d,) or (d, m), "
                                 f"got {mesh_shape}")
        self.mesh = mesh if mesh is not None else make_mesh(
            device=net.device)
        if self.mesh.device != net.device:
            raise ValueError(f"the mesh lives on {self.mesh.device}, the "
                             f"network on {net.device}")
        # batch divisibility and worker accounting follow the data axis only
        self.n = int(self.mesh.shape.get("data", self.mesh.size))
        self.m = model_axis_size(self.mesh)
        self.averaging_frequency = max(1, averaging_frequency)
        self.training_mode = training_mode.lower()
        self.average_updaters = average_updaters
        self.prefetch_buffer = prefetch_buffer
        self.gradient_accumulator = gradient_accumulator
        averaging = (self.training_mode == "averaging"
                     and self.averaging_frequency > 1)
        if gradient_accumulator is not None and averaging:
            raise ValueError(
                "gradient_accumulator applies to the per-step gradient-sharing "
                "path (training_mode='shared_gradients'), not K-step parameter "
                "averaging — the reference makes the same split "
                "(ParallelWrapper.TrainingMode AVERAGING vs SHARED_GRADIENTS)")
        if self.m > 1:
            if averaging:
                raise ValueError(
                    "model-axis sharding applies to the per-step sync "
                    "path; K-step parameter averaging gives each worker "
                    "its own full param copy, which a model-sharded "
                    "layout cannot represent — use "
                    "training_mode='shared_gradients' on a (data, model) "
                    "mesh")
            if gradient_accumulator is not None:
                raise ValueError(
                    "a GradientsAccumulator ravels the full per-worker "
                    "grad tree, which a model-sharded layout cannot feed "
                    "— drop the accumulator on a (data, model) mesh")
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if steps_per_dispatch > 1 and gradient_accumulator is not None:
            raise ValueError(
                "steps_per_dispatch applies to the plain sync all-reduce "
                "path; the GradientsAccumulator path dispatches per step")
        if overlap_sync and gradient_accumulator is not None:
            raise ValueError(
                "overlap_sync schedules the plain psum exchange in buckets; "
                "a GradientsAccumulator owns its own combine — pick one")
        if overlap_sync and averaging:
            raise ValueError(
                "overlap_sync applies to the per-step sync all-reduce path; "
                "the K-step averaging path already runs ONE fused variadic "
                "pmean launch per window — it would silently ignore the "
                "bucket schedule")
        self.overlap_sync = overlap_sync
        self.bucket_bytes = bucket_bytes
        if zero_stage not in (0, 1, 2):
            raise ValueError(f"zero_stage must be 0, 1 or 2, "
                             f"got {zero_stage}")
        if zero_stage and gradient_accumulator is not None:
            raise ValueError(
                "zero_stage shards the plain sync update; a "
                "GradientsAccumulator owns its own combine — pick one")
        if zero_stage and averaging:
            raise ValueError(
                "zero_stage applies to the per-step sync all-reduce "
                "path; the K-step averaging path averages full "
                "per-worker param/state trajectories, which a sharded "
                "updater state cannot represent")
        if zero_stage and overlap_sync:
            raise ValueError(
                "zero_stage already dispatches per-bucket overlapped "
                "collectives (stage 1 is the overlap_sync launch "
                "pattern; stage 2 reduce-scatters the same buckets) — "
                "drop overlap_sync rather than have it silently ignored")
        if self.mesh.group is not None and self.m > 1:
            raise ValueError(
                "on a process-group mesh the wrapper runs the data axis' "
                "paths (plain sync, ZeRO, a GradientsAccumulator, K-step "
                "averaging); a model axis over processes is not ported "
                "(ROADMAP A7b-4b)")
        self.zero_stage = zero_stage
        self.steps_per_dispatch = steps_per_dispatch
        self.step_callback = step_callback
        self._acc_state = None
        self._bucket_schedule = None      # built lazily from the leaves
        self._zero_engine = None          # built lazily from the net
        self._gens: List[torch.Generator] = []   # one a worker
        self._it: Optional[torch.Tensor] = None
        self._windows = WindowGraphs(
            net, lambda f, it: self._sync_step(*f, it),
            lambda f: self._step_math(f[0], f[1], self._it), self._at,
            lambda: self._gens)
        self._worker_opt = None           # averaging without updater mean
        self.prefetcher: Optional[DevicePrefetchIterator] = None

    # ------------------------------------------------------ per worker
    def _at(self, it: int) -> torch.Tensor:
        """Seed every worker's dropout generator for iteration ``it`` (each
        worker draws the same numbers on its shard, as the reference's
        replicated key gives them) and fill the iteration tensor."""
        net = self.net
        if not self._gens:              # one a worker this process runs
            self._gens = [torch.Generator(device=net.device)
                          for _ in range(local_count(self.mesh, "data")
                                         if "data" in self.mesh.shape
                                         else self.n)]
            self._it = torch.zeros((), dtype=torch.int64, device=net.device)
        seed = ((net.conf.seed + 31337) << 32) + it
        for g in self._gens:
            g.manual_seed(seed)
        self._it.fill_(it)
        return self._it

    def _loss_and_grads(self, x, y, gen):
        """The loss on (x, y), its gradient a leaf of ``flat_param_order``
        (zeros for a parameter the loss does not reach) and the forward's
        new layer state, not yet written."""
        leaves = [p for _, _, p in flat_param_order(self.net)]
        with collect_state({}) as new_state:
            loss = self.net.loss_fn(x, y, train=True, gen=gen)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return (loss.detach(),
                [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)], new_state)

    def _worker_grads(self, x, y):
        """Each worker's loss, gradient and new layer state on its shard:
        ``[n]``, one ``[n, *shape]`` a leaf, and the mean of the new states
        over the workers (``pmean``, worker order; {} for a stateless
        network)."""
        sh = data_sharding(self.mesh)
        xs, ys = sh.split(x), sh.split(y)
        runs = [self._loss_and_grads(xs[i], ys[i], self._gens[i])
                for i in range(xs.shape[0])]
        new_state = {
            layer: {k: pmean(torch.stack([r[2][layer][k] for r in runs]),
                             self.mesh, "data")[0] for k in st}
            for layer, st in runs[0][2].items()}
        rows = [torch.stack([r[1][j] for r in runs])
                for j in range(len(runs[0][1]))]
        return torch.stack([r[0] for r in runs]), rows, new_state

    def _apply(self, grads, it: torch.Tensor) -> None:
        """One updater step on the combined gradient, a leaf of
        ``flat_param_order`` each, at the iteration tensor ``it``."""
        net = self.net
        tree = {}
        for (group, name, _), g in zip(flat_param_order(net), grads):
            tree.setdefault(group, {})[name] = g
        net.updater.update(tree, net.opt_state, net.param_dicts(), it)

    def _apply_flat(self, flat: torch.Tensor, it: torch.Tensor) -> None:
        """``_apply`` of one flat gradient ``[P]``."""
        grads, off = [], 0
        for _, _, p in flat_param_order(self.net):
            n = p.numel()
            grads.append(flat[off:off + n].view(p.shape))
            off += n
        self._apply(grads, it)

    def _init_acc_state(self, dtype: torch.dtype) -> torch.Tensor:
        size = int(self.net.num_params())
        per_worker = self.gradient_accumulator.init(size, dtype,
                                                    self.net.device)
        if isinstance(per_worker, tuple) and per_worker == ():
            # stateless accumulator (PsumAccumulator)
            per_worker = torch.zeros(0, dtype=dtype, device=self.net.device)
        rows = local_count(self.mesh, "data")
        return per_worker.expand((rows,) + tuple(per_worker.shape)).clone()

    def _grad_schedule(self):
        """The bucket schedule over the parameters (built once)."""
        if self._bucket_schedule is None:
            self._bucket_schedule = build_bucket_schedule(
                [p for _, _, p in flat_param_order(self.net)],
                self.bucket_bytes)
            reg = get_registry()
            if reg.enabled:
                reg.gauge("parallel.bucket_count").set(
                    len(self._bucket_schedule))
        return self._bucket_schedule

    def _zero(self) -> ZeroUpdateEngine:
        """The ZeRO engine of this network and mesh (built once)."""
        if self._zero_engine is None:
            self._zero_engine = ZeroUpdateEngine.from_net(
                self.net, self.mesh, stage=self.zero_stage,
                bucket_bytes=self.bucket_bytes)
        return self._zero_engine

    def gather_opt_state(self):
        """``net.opt_state`` back in the replicated per-layer format (for a
        model zip, or a path that is not ZeRO's); a no-op if it is in it."""
        if is_zero_state(self.net.opt_state):
            self.net.opt_state = self._zero().unshard_opt_state(
                self.net.opt_state)
        return self.net.opt_state

    # ------------------------------------------------------- the step
    def _step_math(self, x, y, it: torch.Tensor) -> torch.Tensor:
        """One sync iteration on the device, from the generators and the
        iteration tensor ``_at`` set (nothing here reads the host, so it
        captures into a CUDA graph); returns the loss every worker
        reports (the mean of the workers')."""
        net, acc = self.net, self.gradient_accumulator
        leaves = [p for _, _, p in flat_param_order(net)]
        if x.shape[0] % self.n or (acc is None and any(
                net.state_dicts().values())):
            # the remainder batch, where every worker would compute the
            # same whole-batch gradient, and the plain sync step of a
            # network with layer state, whose batch statistics the
            # reference's GSPMD program takes over the whole batch: one
            # step on the whole batch
            loss, grads, new_state = self._loss_and_grads(x, y,
                                                          self._gens[0])
            if self.zero_stage:
                eng = self._zero()
                eng.update(eng.grad_sync(grads, replicated=True),
                           net.opt_state, leaves, it)
            else:
                self._apply(grads, it)
            commit_state(new_state)
            return loss
        losses, rows, new_state = self._worker_grads(x, y)
        if self.zero_stage:
            eng = self._zero()
            eng.update(eng.grad_sync(rows), net.opt_state, leaves, it)
        elif self.overlap_sync:
            means = bucketed_pmean(rows, self._grad_schedule(), self.mesh,
                                   "data")
            self._apply([m[0] for m in means], it)
        else:
            flat = torch.cat([r.reshape(r.shape[0], -1) for r in rows], dim=1)
            if acc is None:
                combined = pmean(flat, self.mesh, "data")
            else:
                if self._acc_state is None:
                    self._acc_state = self._init_acc_state(net.dtype)
                combined, self._acc_state = acc.combine(
                    flat, self._acc_state, self.mesh, axis="data")
            # the combined gradient is the same on every worker: one update
            self._apply_flat(combined[0], it)
        commit_state(new_state)
        return pmean(losses, self.mesh, "data")[0]

    def _sync_step(self, x, y, it: int) -> torch.Tensor:
        """One eager sync iteration at iteration ``it``."""
        if x.shape[0] % self.n and self.gradient_accumulator is not None:
            raise ValueError(
                f"a batch of {x.shape[0]} does not divide over the "
                f"{self.n} workers of the data axis, and the "
                f"GradientsAccumulator path has no replicated step: its "
                f"carry is per worker")
        return self._step_math(x, y, self._at(it))

    def _feed(self, ds):
        net = self.net
        # historical ParallelWrapper semantics: everything to the net's
        # dtype but integer token ids, which an embedding reads
        return (cast_feed(ds.features, net.dtype, net.device),
                cast_feed(ds.labels, net.dtype, net.device))

    # --------------------------------------------------------- windows
    def _window(self, feeds) -> torch.Tensor:
        """The K sync steps of a window from iteration
        ``net.iteration_count`` on (without advancing it); their losses
        ``[K]``: the wrapper's step captured once per key (feed shapes and
        dtypes, the path) and replayed a batch on the card, eager on the
        CPU (``WindowGraphs``)."""
        return self._windows.run(feeds, (self.zero_stage, self.overlap_sync))

    def graph_stats(self) -> dict:
        """The window graphs' captures and replays so far and each counted
        kernel's launches made by replays (``WindowGraphs.stats``)."""
        return self._windows.stats()

    # ------------------------------------------------------- averaging
    def _leaf_groups(self):
        """The network's parameters, layer state and updater state as
        three lists of tensors."""
        net = self.net
        return ([p for _, _, p in flat_param_order(net)],
                [t for sd in net.state_dicts().values()
                 for t in sd.values()],
                [t for *_, t in flat_opt_state_order(net)])

    @torch.no_grad()
    def _load(self, dst, src) -> None:
        for group_d, group_s in zip(dst, src):
            for d, s in zip(group_d, group_s):
                d.copy_(s)

    def _run_avg(self, buf) -> torch.Tensor:
        """K local steps a worker on its shard of each batch, then the mean
        of the workers' parameters, layer state and (``average_updaters``)
        updater state (reference ``_build_avg_step`` / ``_run_avg``). The
        workers run one after another from the same start on the one
        network; a batch that does not tile the mesh runs once, whole (every
        worker's trajectory is the same, so the mean is that trajectory).
        Without ``average_updaters`` each worker keeps its own updater
        state from window to window, worker 0's in ``net.opt_state``, as
        each device keeps its own in the reference's program. On a
        process-group mesh a process runs its own worker's trajectory, the
        means run over the processes, and ``net.opt_state`` without
        ``average_updaters`` is its own worker's; a batch that does not
        tile the mesh runs whole on every process, the same trajectory
        everywhere, so no mean is taken. Returns the mean loss (over the
        K steps, then the workers)."""
        net, n = self.net, self.n
        it0 = net.iteration_count
        feeds = [self._feed(d) for d in buf]
        whole = feeds[0][0].shape[0] % n != 0
        live = self._leaf_groups()
        start = [[t.detach().clone() for t in g] for g in live]
        sh = data_sharding(self.mesh)
        shards = None if whole else [(sh.split(x), sh.split(y))
                                     for x, y in feeds]
        ends, losses = [], []
        for w in range(1 if whole else local_count(self.mesh, "data")):
            own = (self._worker_opt[w] if self._worker_opt is not None
                   and not self.average_updaters else start[2])
            self._load(live, (start[0], start[1], own))
            steps = []
            for i in range(len(buf)):
                x, y = feeds[i] if whole else (shards[i][0][w],
                                               shards[i][1][w])
                it = self._at(it0 + i)
                steps.append(train_step_math(net, x, y, gen=self._gens[w],
                                             it=it))
            losses.append(torch.stack(steps).mean())
            ends.append([[t.detach().clone() for t in g] for g in live])
        if whole:
            self._load(live, ends[0])
            return losses[0]
        mean = lambda j, k: pmean(torch.stack([e[j][k] for e in ends]),
                                  self.mesh, "data")[0]
        avg = [[mean(j, k) for k in range(len(live[j]))] for j in (0, 1)]
        if self.average_updaters:
            avg.append([mean(2, k) for k in range(len(live[2]))])
        else:
            self._worker_opt = [e[2] for e in ends]
            avg.append(ends[0][2])
        self._load(live, avg)
        return pmean(torch.stack(losses), self.mesh, "data")[0]

    # ------------------------------------------------------------- fit
    def fit(self, iterator, epochs: int = 1, *, skip_first_batches: int = 0):
        net = self.net
        if skip_first_batches < 0:
            raise ValueError("skip_first_batches must be >= 0")
        if not net.initialized:
            net.init()
        axis_size(self.mesh, "data")
        sync = (self.training_mode == "shared_gradients"
                or self.averaging_frequency == 1)
        # the model axis' layout (tensor_parallel rules; nothing at m = 1
        # on a network that holds no rows), then the ZeRO layout over it
        place_net(net, self.m)
        if sync and self.zero_stage:
            # the engine owns the updater state's format: a replicated
            # state is sharded on entry, a sharded one checked
            net.opt_state = self._zero().shard_opt_state(net.opt_state)
        if isinstance(iterator, DevicePrefetchIterator):
            feed = iterator
        elif self.prefetch_buffer >= 1:
            feed = DevicePrefetchIterator(iterator, self.prefetch_buffer,
                                          device=net.device, dtype=net.dtype)
        else:
            feed = iterator
        self.prefetcher = (feed if isinstance(feed, DevicePrefetchIterator)
                           else None)
        reg = get_registry()
        with span("fit", epochs=epochs, mode=self.training_mode,
                  devices=self.n, net="ParallelWrapper"):
            for epoch in range(epochs):
                with span("epoch", index=epoch):
                    self._fit_epoch(feed, iterator, sync,
                                    skip_first_batches if epoch == 0
                                    else 0, reg)
            if self.m > 1 and reg.enabled:
                # a rank's footprint once laid out: a model-sharded leaf
                # counts one row of its m
                reg.gauge("parallel.model_axis").set(self.m)
                params = net.param_dicts()
                reg.gauge("parallel.param_bytes_per_replica").set(
                    per_replica_bytes(params, tree_specs(net, params)))
                reg.gauge("parallel.opt_bytes_per_replica").set(
                    per_replica_bytes(net.opt_state,
                                      tree_specs(net, net.opt_state)))
        return net

    def _collectives(self) -> Tuple[int, int]:
        """(buckets, collectives) of one sync step on the mesh: a bucket's
        reduction each, ZeRO's all-gather a group, plus the fused state
        and loss mean; (0, 0) on the plain and the accumulator paths, as
        the reference counts them."""
        if self.zero_stage:
            eng = self._zero()
            return eng.num_reduce_launches, eng.collectives_per_step + 1
        if self.overlap_sync:
            n = len(self._grad_schedule())
            return n, n + 1
        return 0, 0

    def _step_collectives(self, x, n_coll: int) -> int:
        """A step's collectives on a batch ``x``: a batch that does not tile
        the mesh takes the whole-batch step, which keeps ZeRO's and runs
        no other (the reference's remainder programs)."""
        if x.shape[0] % self.n and not self.zero_stage:
            return 0
        return n_coll

    def _fit_epoch(self, feed, iterator, sync: bool, skip: int,
                   reg) -> None:
        net = self.net
        epoch_hook(net.listeners, "on_epoch_start", net)
        clock = EtlClock(self.prefetcher)
        # the mid-epoch resume: batches the checkpointed run trained are
        # consumed, not trained (see Solver._fit_epoch)
        src = skip_batches(feed, skip) if skip else iter(feed)
        if skip:
            clock.skipped()
        if sync:
            # resolved once an epoch: one locked add an iteration
            c_iters = reg.counter("train.iterations")
            c_windows = reg.counter("train.windows")
            c_coll = reg.counter("parallel.collective_launches")
            buckets, n_coll = self._collectives()
            windowed = (self.steps_per_dispatch > 1
                        and self.gradient_accumulator is None)
            for item in (iter_windows(src, self.steps_per_dispatch)
                         if windowed else src):
                etl_ms = clock.etl_ms()
                if isinstance(item, BatchWindow):
                    k = len(item)
                    with span("window", k=k, iteration=net.iteration_count):
                        feeds = [self._feed(d) for d in item.datasets]
                        with span("dispatch", k=k, buckets=buckets):
                            losses = self._window(feeds)
                        c_windows.inc()
                        c_iters.inc(k)
                        nc = self._step_collectives(feeds[0][0], n_coll)
                        if nc:
                            c_coll.inc(k * nc)
                        notify_window(net, item.datasets, losses, etl_ms,
                                      clock.device_ms(etl_ms))
                else:
                    k = 1
                    # the step is the dispatch on this path: one span
                    with span("step", iteration=net.iteration_count):
                        x, y = self._feed(item)
                        loss = self._sync_step(x, y, net.iteration_count)
                        c_iters.inc()
                        nc = self._step_collectives(x, n_coll)
                        if nc:
                            c_coll.inc(nc)
                        notify_batch(net, item, loss, etl_ms,
                                     clock.device_ms(etl_ms))
                        net.iteration_count += 1
                if self.step_callback is not None:
                    self.step_callback(net, k)
                clock.restart()
        else:
            # K batches, then the K-step program and the average
            buf: List = []
            for ds in src:
                buf.append(ds)
                if len(buf) == self.averaging_frequency:
                    self._avg_window(buf)
                    buf = []
            if buf:
                self._avg_window(buf)
        epoch_hook(net.listeners, "on_epoch_end", net)
        if hasattr(iterator, "reset"):
            iterator.reset()

    def _avg_window(self, buf) -> None:
        net, k = self.net, len(buf)
        with span("window", k=k, kind="averaging",
                  iteration=net.iteration_count):
            with span("dispatch", k=k):
                loss = self._run_avg(buf)
            reg = get_registry()
            reg.counter("train.windows").inc()
            reg.counter("train.iterations").inc(k)
            # every batch of the window reports the window's mean loss
            notify_window(net, buf, [loss] * k)
        if self.step_callback is not None:
            self.step_callback(self.net, len(buf))
