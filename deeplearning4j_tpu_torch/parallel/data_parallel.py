"""Data-parallel training: ``ParallelWrapper`` on a logical mesh.

Counterpart of ``deeplearning4j_tpu/parallel/data_parallel.py``
``ParallelWrapper`` (``:52``): the constructor's arguments and refusals as
they stand (``:107-257``) and ``fit`` / ``_fit_epoch`` / ``_notify`` for the
per-step synchronous path:

- the accumulator step (``_build_accum_step`` ``:562-593``,
  ``_init_acc_state`` ``:595-601``): each worker's loss and gradient on its
  shard of the batch, the flat gradient in ``ravel_pytree``'s order
  (vertices or layers in order, each one's parameter names sorted),
  ``gradient_accumulator.combine``, one updater step on the combined
  gradient, the loss averaged over the workers. The carry ``_acc_state`` is
  ``[n, num_params]``;
- the plain sync step (``:308-327``): the mean of the workers' gradients;
- the replicated step for a batch that does not tile the mesh
  (``:847-851``): one step on the whole batch, which is the same update.
  The accumulator path keeps the reference's loud error there (its
  per-worker carry has no replicated equivalent).

It wraps a ``MultiLayerNetwork`` or a ``ComputationGraph``. The workers are
the rows of ``parallel/mesh.py``'s logical mesh on one device: their
forward and backward passes run one after the other, every worker drawing
the same dropout numbers on its shard, as the reference's replicated key
gives them. A port network carries no non-parameter state, so only the loss
is averaged where the reference averages state and loss. Not ported yet,
each raising ``NotImplementedError`` that names its ROADMAP item: K-step
parameter averaging, ``steps_per_dispatch > 1``, ``overlap_sync``,
``zero_stage``, a model axis and ``step_callback`` (A7b); device prefetch,
``prefetch_buffer >= 1`` (A10: the default here is 0, batches are fed as
they come); epoch and performance listeners (A8, refused by
``set_listeners``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..optimize.solver import cast_feed
from .mesh import Mesh, axis_size, data_sharding, make_mesh, pmean

DEFAULT_BUCKET_BYTES = 4 * 2 ** 20
MODEL_AXIS = "model"


def flat_param_order(net) -> List[Tuple[object, str, torch.nn.Parameter]]:
    """(group, name, parameter) for every parameter of ``net`` in the order
    the reference's ``ravel_pytree(grads)`` flattens them: vertices (or
    layers) in the network's order, each one's names sorted."""
    return [(group, name, pd[name])
            for group, pd in net.param_dicts().items()
            for name in sorted(pd)]


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
                 average_updaters: bool = True, prefetch_buffer: int = 0,
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
        self.m = int(self.mesh.shape.get(MODEL_AXIS, 1))
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
        self.zero_stage = zero_stage
        self.steps_per_dispatch = steps_per_dispatch
        self.step_callback = step_callback
        self._acc_state = None
        # what the port does not run yet, after every refusal above
        for asked, what in (
                (averaging, "K-step parameter averaging "
                            "(training_mode='averaging', "
                            "averaging_frequency > 1)"),
                (steps_per_dispatch > 1, "fused K-step windows "
                                         "(steps_per_dispatch > 1)"),
                (overlap_sync, "bucketed overlap sync (overlap_sync)"),
                (zero_stage, "the ZeRO sharded update (zero_stage)"),
                (self.m > 1, "a model axis (tensor parallelism)"),
                (step_callback is not None, "step_callback and its users "
                                            "(the elastic trainer)")):
            if asked:
                raise NotImplementedError(f"{what} is not ported yet "
                                          f"(ROADMAP A7b)")
        if prefetch_buffer >= 1:
            raise NotImplementedError(
                "device prefetch (prefetch_buffer >= 1) is not ported yet "
                "(ROADMAP A10); the default 0 feeds batches as they come")

    # -------------------------------------------------------------- the steps
    def _worker_grads(self, x, y, gen, seed) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """Each worker's loss and flat gradient on its shard: ``[n]`` and
        ``[n, P]``. Every worker reseeds ``gen`` alike."""
        sh = data_sharding(self.mesh)
        xs, ys = sh.split(x), sh.split(y)
        pairs = [self._loss_and_flat_grad(xs[i], ys[i], gen, seed)
                 for i in range(self.n)]
        return (torch.stack([loss for loss, _ in pairs]),
                torch.stack([flat for _, flat in pairs]))

    def _loss_and_flat_grad(self, x, y, gen, seed):
        """The loss on (x, y) and its gradient as one flat vector in
        ``flat_param_order`` (zeros for a parameter the loss does not
        reach)."""
        leaves = [p for _, _, p in flat_param_order(self.net)]
        gen.manual_seed(seed)
        loss = self.net.loss_fn(x, y, train=True, gen=gen)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for g, p in zip(grads, leaves)])
        return loss.detach(), flat

    def _apply(self, flat: torch.Tensor, it: int) -> None:
        """One updater step on the flat combined gradient ``[P]``."""
        net = self.net
        grads, off = {}, 0
        for group, name, p in flat_param_order(net):
            n = p.numel()
            grads.setdefault(group, {})[name] = flat[off:off + n].reshape(
                p.shape)
            off += n
        net.updater.update(grads, net.opt_state, net.param_dicts(), it)

    def _init_acc_state(self, dtype: torch.dtype) -> torch.Tensor:
        size = int(self.net.num_params())
        per_worker = self.gradient_accumulator.init(size, dtype,
                                                    self.net.device)
        if isinstance(per_worker, tuple) and per_worker == ():
            # stateless accumulator (PsumAccumulator)
            per_worker = torch.zeros(0, dtype=dtype, device=self.net.device)
        return per_worker.expand((self.n,) + tuple(per_worker.shape)).clone()

    def _sync_step(self, x, y, gen, seed, it) -> torch.Tensor:
        """One per-step sync iteration; returns the loss every worker
        reports (the mean of the workers')."""
        net, acc = self.net, self.gradient_accumulator
        if x.shape[0] % self.n:
            if acc is not None:
                raise ValueError(
                    f"a batch of {x.shape[0]} does not divide over the "
                    f"{self.n} workers of the data axis, and the "
                    f"GradientsAccumulator path has no replicated step: its "
                    f"carry is per worker")
            # remainder batch: every worker would compute the same
            # whole-batch gradient, so it is computed once
            loss, flat = self._loss_and_flat_grad(x, y, gen, seed)
            self._apply(flat, it)
            return loss
        losses, flat = self._worker_grads(x, y, gen, seed)
        if acc is None:
            combined = pmean(flat, self.mesh, "data")
        else:
            if self._acc_state is None:
                self._acc_state = self._init_acc_state(net.dtype)
            combined, self._acc_state = acc.combine(flat, self._acc_state,
                                                    self.mesh, axis="data")
        # the combined gradient is the same on every worker: one update
        self._apply(combined[0], it)
        return pmean(losses, self.mesh, "data")[0]

    # ------------------------------------------------------------------- fit
    def fit(self, iterator, epochs: int = 1, *, skip_first_batches: int = 0):
        net = self.net
        if skip_first_batches < 0:
            raise ValueError("skip_first_batches must be >= 0")
        if skip_first_batches:
            raise NotImplementedError("the mid-epoch resume "
                                      "(skip_first_batches) is not ported "
                                      "yet (ROADMAP A10)")
        if not net.initialized:
            net.init()
        axis_size(self.mesh, "data")
        gen = torch.Generator(device=net.device)
        for _ in range(epochs):
            self._fit_epoch(iterator, gen)
        return net

    def _fit_epoch(self, iterator, gen) -> None:
        net = self.net
        base_seed = net.conf.seed + 31337
        for ds in iterator:
            # historical ParallelWrapper semantics: everything to the
            # net's dtype but integer token ids, which an embedding reads
            x = cast_feed(ds.features, net.dtype, net.device)
            y = cast_feed(ds.labels, net.dtype, net.device)
            loss = self._sync_step(x, y, gen,
                                   (base_seed << 32) + net.iteration_count,
                                   net.iteration_count)
            self._notify(loss)
            net.iteration_count += 1
        if hasattr(iterator, "reset"):
            iterator.reset()

    def _notify(self, loss) -> None:
        net = self.net
        for lis in net.listeners:
            lis.iteration_done(net, net.iteration_count, loss)
