"""ZeRO-style sharding of the weight update across the data-parallel workers.

Counterpart of ``deeplearning4j_tpu/parallel/zero.py`` (arXiv 2004.13336):
``is_zero_state`` (``:66-70``), the leaf metadata (``:97-127``),
``ZeroUpdateEngine`` (``:143-569``) and ``make_zero_resharder``
(``:660-719``). Each of the n workers applies the updater to 1/n of the
flattened update and holds only its shard of the updater state; the
updated parameters are then gathered back to every worker.

- **Layout.** The leaves (``data_parallel.flat_param_order``) are grouped
  by ``(dtype, update rule, lr multiplier)``, so a group's update is one
  elementwise program with one learning rate. A frozen layer's leaves
  take no part. Within a group the leaves are packed into buckets by
  ``overlap.build_bucket_schedule``; bucket b of ``nb`` elements is padded
  with zeros to ``n * lb`` (``lb = ceil(nb / n)``) and cut ``[n, lb]``, and
  worker k's shard of the group is row k of every padded bucket, joined.
  The layout is host metadata (``sharding_meta``), so a state saved for
  one worker count re-shards onto another (``reshard_state_leaf``,
  ``make_zero_resharder``: all-gather, then re-slice; arXiv 2112.01075).
- **The state** is ``{"_zero_": (group 0, group 1, ...)}``, each group a
  dict of state name -> ``[n, length]``: row k is worker k's shard, the
  reference's ``[N, L]`` array sharded on the data axis, here on the
  logical mesh (``parallel/mesh.py``) as the worker axis leading. On a
  process-group mesh a process holds only its own row, ``[1, length]``:
  its updater bytes are the replicated bytes / n, plus padding. There
  stage 2's reduce-scatter hands the backend (n-1)/n of a bucket a
  process, stage 1's all-reduce a whole bucket, and the gather 1/n.
- **A step.** ``grad_sync`` takes each leaf's per-worker gradient
  ``[n, *shape]`` and gives each group's mean-gradient shards
  ``[n, length]``: stage 1 by the bucket's all-reduce (``pmean``) and a
  slice, stage 2 by a reduce-scatter (``psum_scatter``, then / n); both
  add the rows in worker order and divide by n, as ``pmean`` does, so the
  shards are bitwise the plain sync path's mean gradient. A batch that
  every worker computes whole (the remainder that does not tile the mesh)
  gives its gradient as the mean as it is. ``update`` then runs the
  layer's rule (``update_one``, the same learning rate and iteration terms
  as ``MultiLayerUpdater.update``) on every worker's shard at once (one
  ``[n, length]`` program, elementwise each worker's), writes the new state
  shards in place and gathers the updated parameters (``all_gather``) back
  into the network's tensors, in place. Each element sees the
  arithmetic the per-leaf update gives it, so the result is bitwise the
  replicated update's, on the CPU and on the card (the reference's bitwise
  pin fails by one ulp on its own CPU backend; ROADMAP "Faults of the
  reference").
- **Host plumbing.** ``shard_opt_state`` packs a replicated
  ``MultiLayerUpdater.init``-shaped state (refusing nonzero state of a
  frozen leaf), ``unshard_opt_state`` gives it back (a frozen leaf's state
  as its rule's init zeros), bitwise both ways; ``check_state`` refuses a
  state shaped for another worker count. ``shard_state_bytes`` against
  ``replicated_state_bytes`` is the saving a worker.

- **Telemetry.** A new engine sets the ``zero.shard_bytes``,
  ``zero.gathered_bytes`` and ``zero.groups`` gauges (reference
  ``:266-271``). ``profile`` (``:572-651``) times each bucket's gradient
  collective (stage 2's reduce-scatter, recorded as ``reduce_scatter``
  spans; stage 1's all-reduce and slice, ``grad_allreduce``) and each
  group's all-gather (``all_gather`` spans under a ``zero.allgather``
  span), sets ``zero.reduce_scatter_ms`` and ``zero.allgather_ms`` and
  refreshes the gauges. The mesh is logical, so these times measure the
  collectives' kernels and copies on the one device, not a wire: a
  reduction is the rows' adds, and an all-gather a broadcast view whose
  time is the host's.

``parallel/elastic.py``'s ``ElasticTrainer``
drives it with ``zero_stage``: one engine a worker set, its
``sharding_meta`` in every save and ``make_zero_resharder`` onto a shrunk
mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..telemetry import get_registry, record_external_span, span
from .mesh import (Mesh, all_gather, keep_local, local_count, pmean,
                   psum_scatter)
from .overlap import (DEFAULT_BUCKET_BYTES, build_bucket_schedule,
                      time_collective)

__all__ = ["ZeroUpdateEngine", "is_zero_state", "make_zero_resharder",
           "ZERO_STATE_KEY"]

ZERO_STATE_KEY = "_zero_"


def is_zero_state(opt_state: Any) -> bool:
    """True if ``opt_state`` is the engine's sharded format (a dict with the
    single key ``_zero_``)."""
    return isinstance(opt_state, dict) and set(opt_state) == {ZERO_STATE_KEY}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16"), as the
    reference's manifests write it."""
    return str(dtype).replace("torch.", "")


@dataclass(frozen=True)
class _ZeroBucket:
    """One reduce-scatter: ``indices`` are leaf positions, packed flat to
    ``nb`` elements and padded to ``n_shards * lb``."""
    indices: Tuple[int, ...]
    sizes: Tuple[int, ...]
    nb: int
    lb: int


@dataclass(frozen=True)
class _ZeroGroup:
    """One elementwise update: every member leaf shares ``dtype``, the
    update ``rule`` and ``lr_mult``."""
    rule: Any
    lr_mult: float
    dtype: torch.dtype
    buckets: Tuple[_ZeroBucket, ...]
    length: int                      # a shard's elements, padding included
    state_keys: Tuple[str, ...]


def _leaf_meta_from_net(net):
    """Per leaf (``flat_param_order``): (rule or None, lr multiplier,
    frozen rule or None) and its (group, parameter name), as
    ``MultiLayerUpdater.update`` resolves them. A None rule marks a
    frozen layer's leaf; its rule is kept to rebuild the init-shaped state
    the replicated format holds for it."""
    from .data_parallel import flat_param_order
    upd = net.updater
    if getattr(upd, "grad_norm", None) not in (None, "none"):
        raise ValueError(
            "zero sharded update does not compose with gradient "
            "normalization: the per-layer norms need every full leaf, "
            "which no replica holds after the reduce-scatter — disable "
            "grad_norm or the zero_stage")
    rules, mults, frozen, keys = [], [], [], []
    for group, pname, _ in flat_param_order(net):
        conf = upd.layer_confs[group]
        keys.append((group, pname))
        if getattr(conf, "frozen", False):
            rules.append(None)
            mults.append(1.0)
            frozen.append(upd.rule_for(conf))
            continue
        rules.append(upd.rule_for(conf))
        mults.append(float(upd._lr_mult(conf, pname)))
        frozen.append(None)
    return rules, mults, frozen, keys


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


class ZeroUpdateEngine:
    """The sharded update over one axis of a logical mesh (see the module
    docstring):

        eng = ZeroUpdateEngine.from_net(net, mesh, stage=2)
        shards = eng.grad_sync(per_worker_grads)
        eng.update(shards, net.opt_state, leaves, it)
    """

    def __init__(self, leaves: Sequence[torch.Tensor], rules, lr_mults, *,
                 n_shards: int, stage: int = 1,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 axis: str = "data", mesh: Optional[Mesh] = None,
                 frozen_rules=None, leaf_keys=None, groups_order=None):
        if stage not in (1, 2):
            raise ValueError(f"zero stage must be 1 or 2, got {stage}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        leaves = list(leaves)
        if len(rules) != len(leaves) or len(lr_mults) != len(leaves):
            raise ValueError("rules/lr_mults must align with the params "
                             "leaves")
        self.n = int(n_shards)
        self.stage = stage
        self.axis = axis
        self.mesh = mesh
        # the shard rows this process holds: all n on a logical mesh, its
        # own worker's one on a process-group mesh
        self.local = (local_count(mesh, axis) if mesh is not None
                      else self.n)
        self.bucket_bytes = bucket_bytes
        self.leaf_shapes = [tuple(t.shape) for t in leaves]
        self.leaf_dtypes = [t.dtype for t in leaves]
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self.frozen_rules = (list(frozen_rules) if frozen_rules is not None
                             else [None] * len(leaves))
        # (layer key, parameter name) a leaf, and every layer key (those
        # without parameters too): the replicated format's nesting
        self.leaf_keys = (list(leaf_keys) if leaf_keys is not None
                          else [(i, "p") for i in range(len(leaves))])
        self.layer_keys = (list(groups_order) if groups_order is not None
                           else list(dict.fromkeys(g for g, _ in
                                                   self.leaf_keys)))
        self.groups = self._build_groups(leaves, rules, lr_mults)
        self._publish_gauges()

    @classmethod
    def from_net(cls, net, mesh: Mesh, *, stage: int = 1,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 axis: str = "data") -> "ZeroUpdateEngine":
        from .data_parallel import flat_param_order
        rules, mults, frozen, keys = _leaf_meta_from_net(net)
        n_shards = int(mesh.shape.get(axis, mesh.size))
        return cls([p for _, _, p in flat_param_order(net)], rules, mults,
                   n_shards=n_shards, stage=stage, bucket_bytes=bucket_bytes,
                   axis=axis, mesh=mesh, frozen_rules=frozen, leaf_keys=keys,
                   groups_order=list(net.param_dicts()))

    # ----------------------------------------------------------- layout
    def _build_groups(self, leaves, rules, lr_mults) -> Tuple[_ZeroGroup, ...]:
        order: List[tuple] = []
        members: Dict[tuple, List[int]] = {}
        for i, (rule, mult) in enumerate(zip(rules, lr_mults)):
            if rule is None:        # frozen: never updated
                continue
            key = (self.leaf_dtypes[i], rule, mult)
            if key not in members:
                members[key] = []
                order.append(key)
            members[key].append(i)
        groups = []
        for key in order:
            dtype, rule, mult = key
            idxs = members[key]
            sched = build_bucket_schedule([leaves[i] for i in idxs],
                                          self.bucket_bytes)
            buckets = []
            for b in sched.buckets:
                gidx = tuple(idxs[j] for j in b.indices)
                sizes = tuple(_numel(self.leaf_shapes[i]) for i in gidx)
                nb = sum(sizes)
                lb = -(-nb // self.n)        # ceil
                buckets.append(_ZeroBucket(gidx, sizes, nb, lb))
            length = sum(b.lb for b in buckets)
            state_keys = tuple(sorted(rule.init_one(
                torch.zeros((1,), dtype=dtype)).keys()))
            groups.append(_ZeroGroup(rule, mult, dtype, tuple(buckets),
                                     length, state_keys))
        return tuple(groups)

    @property
    def num_reduce_launches(self) -> int:
        """Collectives in a step's gradient sync (one a bucket)."""
        return sum(len(g.buckets) for g in self.groups)

    @property
    def collectives_per_step(self) -> int:
        """The reduce launches and one all-gather a group."""
        return self.num_reduce_launches + len(self.groups)

    @property
    def shard_state_bytes(self) -> int:
        """A worker's updater-state bytes under sharding."""
        return sum(g.length * _itemsize(g.dtype) * len(g.state_keys)
                   for g in self.groups)

    @property
    def replicated_state_bytes(self) -> int:
        """The same updater state's bytes a worker, unsharded."""
        return sum(sum(b.nb for b in g.buckets) * _itemsize(g.dtype)
                   * len(g.state_keys) for g in self.groups)

    @property
    def gathered_bytes(self) -> int:
        """Bytes all-gathered a step (padded parameter shards)."""
        return sum(g.length * self.n * _itemsize(g.dtype)
                   for g in self.groups)

    def _publish_gauges(self) -> None:
        reg = get_registry()
        if reg.enabled:
            reg.gauge("zero.shard_bytes").set(float(self.shard_state_bytes))
            reg.gauge("zero.gathered_bytes").set(float(self.gathered_bytes))
            reg.gauge("zero.groups").set(float(len(self.groups)))

    def sharding_meta(self) -> dict:
        """The checkpoint manifest's ``sharding`` block, as the
        reference's: enough to rebuild this layout, or re-shard it for
        another worker count (a bucket's elements do not depend on n)."""
        return {"format": "zero-flat", "axis": self.axis,
                "num_shards": self.n, "stage": self.stage,
                "bucket_bytes": int(self.bucket_bytes),
                "groups": [{"dtype": dtype_name(g.dtype),
                            "state_keys": list(g.state_keys),
                            "bucket_elems": [b.nb for b in g.buckets]}
                           for g in self.groups]}

    def meta_matches(self, meta: Optional[dict]) -> bool:
        """True if a manifest's ``sharding`` block describes this layout
        (so the saved state restores as it is)."""
        if not meta or meta.get("format") != "zero-flat":
            return False
        mine = self.sharding_meta()
        return (meta.get("num_shards") == mine["num_shards"]
                and meta.get("axis") == mine["axis"]
                and meta.get("groups") == mine["groups"])

    # ----------------------------------------------------- pack / unpack
    def _mine(self, t: torch.Tensor) -> torch.Tensor:
        """This process's rows of an ``[n, ...]`` tensor (all of them on a
        logical mesh)."""
        return t if self.mesh is None else keep_local(t, self.mesh,
                                                      self.axis)

    def _pack_rows(self, b: _ZeroBucket, rows) -> torch.Tensor:
        """One bucket of this process's per-worker leaves
        ``[local, *shape]``, flattened and padded a worker:
        ``[local, n * lb]``."""
        n, local = self.n, self.local
        parts = [rows[i].reshape(local, -1) for i in b.indices]
        pad = n * b.lb - b.nb
        if pad:
            parts.append(parts[0].new_zeros((local, pad)))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _pack_whole(self, b: _ZeroBucket, leaves) -> torch.Tensor:
        """One bucket of whole leaves, flattened, padded and cut into the
        workers' shards: ``[n, lb]`` (row k is worker k's)."""
        parts = [leaves[i].reshape(-1) for i in b.indices]
        pad = self.n * b.lb - b.nb
        if pad:
            parts.append(parts[0].new_zeros((pad,)))
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        return flat.view(self.n, b.lb)

    def _join(self, parts) -> torch.Tensor:
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _unpack_group(self, g: _ZeroGroup, full: torch.Tensor, leaves):
        """Copy the gathered ``[n, length]`` group (row-major ``[n, lb]`` a
        bucket: the padded bucket) into the leaf tensors, in place."""
        off = 0
        for b in g.buckets:
            flat = full[:, off:off + b.lb].reshape(self.n * b.lb)
            pos = 0
            for i, size in zip(b.indices, b.sizes):
                leaves[i].copy_(flat[pos:pos + size].view(
                    self.leaf_shapes[i]))
                pos += size
            off += b.lb

    # ------------------------------------------------ the update seam
    def grad_sync(self, rows: Sequence[torch.Tensor],
                  replicated: bool = False) -> Tuple[torch.Tensor, ...]:
        """Each group's mean-gradient shards ``[local, length]`` (row k is
        worker k's; this process's one on a process-group mesh) from each
        leaf's per-worker gradient ``rows[i]`` ``[local, *shape]``: one
        collective a bucket (stage 1: all-reduce and slice; stage 2:
        reduce-scatter). ``replicated``: ``rows[i]`` is the whole batch's
        gradient ``[*shape]``, which every worker holds; it is the mean as
        it is."""
        if len(rows) != len(self.leaf_shapes):
            raise ValueError("grad tree does not match the zero layout — "
                             "rebuild the engine when the parameter "
                             "structure changes")
        mesh, n = self.mesh, self.n
        shards = []
        for g in self.groups:
            parts = []
            for b in g.buckets:
                if replicated:
                    parts.append(self._mine(self._pack_whole(b, rows)))
                    continue
                packed = self._pack_rows(b, rows)
                if self.stage == 1:
                    red = pmean(packed, mesh, self.axis)
                    # worker k's slice of its all-reduced copy: on a
                    # logical mesh the copies are one tensor, so its rows
                    # are the shards
                    parts.append(self._mine(red[0].view(n, b.lb)))
                else:
                    parts.append(psum_scatter(
                        packed.view(self.local, n, b.lb), mesh,
                        self.axis) / n)
            shards.append(self._join(parts))
        return tuple(shards)

    @torch.no_grad()
    def update(self, shards, opt_state, leaves: Sequence[torch.Tensor],
               step) -> None:
        """The rule on every worker's shard (state shard-sized, updated in
        place), then the updated parameters gathered into ``leaves`` in
        place. ``shards`` is what ``grad_sync`` gave; ``step`` the
        iteration (a 0-dim tensor)."""
        from ..optimize.updaters import step_tensor
        if not is_zero_state(opt_state):
            raise ValueError(
                "zero update needs the engine's sharded opt state — "
                "convert with shard_opt_state() before dispatch")
        if len(leaves) != len(self.leaf_shapes):
            raise ValueError("param tree does not match the zero layout — "
                             "rebuild the engine when the parameter "
                             "structure changes")
        st = opt_state[ZERO_STATE_KEY]
        step = step_tensor(step)
        for gi, g in enumerate(self.groups):
            p_loc = self._mine(self._join([self._pack_whole(b, leaves)
                                           for b in g.buckets]))
            s_loc = st[gi]
            lr = g.rule.lr(step, g.lr_mult)
            upd, ns = g.rule.update_one(shards[gi], s_loc, lr, step,
                                        g.rule.step_terms(step))
            new_loc = p_loc - upd.to(p_loc.dtype)
            for key, v in s_loc.items():
                v.copy_(ns[key])
            full = all_gather(new_loc, self.mesh, self.axis)[0] \
                if self.mesh is not None else new_loc
            self._unpack_group(g, full, leaves)

    # ---------------------------------------------- host-side plumbing
    def init_opt_state(self) -> dict:
        """Fresh (zero) sharded updater state."""
        return {ZERO_STATE_KEY: tuple(
            {key: torch.zeros((self.local, g.length), dtype=g.dtype,
                              device=self.device)
             for key in g.state_keys} for g in self.groups)}

    def _leaf_state_list(self, opt_state) -> List[dict]:
        """Per leaf, its {state name: tensor} dict from the replicated
        format (nested by layer key, then parameter name)."""
        try:
            out = [opt_state[g][p] for g, p in self.leaf_keys]
        except (KeyError, IndexError, TypeError) as e:
            raise ValueError(
                "replicated opt state does not align with the zero "
                "layout's param tree — was it built by this net's "
                f"updater.init? ({e})") from e
        if not all(isinstance(s, dict) for s in out):
            raise ValueError(
                "replicated opt state does not align with the zero "
                "layout's param tree: expected a {state_key: array} dict "
                "at every param-leaf position")
        return out

    @torch.no_grad()
    def shard_opt_state(self, opt_state) -> dict:
        """The replicated (``MultiLayerUpdater.init``-shaped) state packed
        into the sharded format; a sharded state is checked and returned.
        Nonzero state of a frozen leaf is refused."""
        if is_zero_state(opt_state):
            self.check_state(opt_state)
            return opt_state
        flat_state = self._leaf_state_list(opt_state)
        for i, fr in enumerate(self.frozen_rules):
            if fr is None:
                continue
            for key, v in flat_state[i].items():
                if bool(torch.any(v != 0)):
                    raise ValueError(
                        f"frozen leaf {i} carries nonzero updater state "
                        f"({key!r}); the sharded format does not store "
                        f"frozen state (it is never updated) — zero it "
                        f"or unfreeze the layer before zero_stage "
                        f"training")
        groups = []
        for g in self.groups:
            groups.append({key: self._mine(self._join(
                [self._pack_whole(b, [None if s is None or key not in s
                                      else s[key] for s in flat_state])
                 for b in g.buckets])).clone()
                for key in g.state_keys})
        return {ZERO_STATE_KEY: tuple(groups)}

    @torch.no_grad()
    def unshard_opt_state(self, opt_state) -> dict:
        """The replicated per-leaf state rebuilt from the sharded format
        (all-gather; on a process-group mesh every process must call it):
        ``MultiLayerUpdater.init``'s shape, a frozen leaf's state its
        rule's init zeros, a stateless leaf ``{}``."""
        self.check_state(opt_state)
        flat_state: List[Optional[dict]] = [None] * len(self.leaf_shapes)
        for gi, g in enumerate(self.groups):
            for key in g.state_keys:
                full = opt_state[ZERO_STATE_KEY][gi][key]
                if self.local != self.n:
                    full = all_gather(full, self.mesh, self.axis)[0]
                off = 0
                for b in g.buckets:
                    flat = full[:, off:off + b.lb].reshape(self.n * b.lb)
                    pos = 0
                    for i, size in zip(b.indices, b.sizes):
                        d = flat_state[i] or {}
                        d[key] = flat[pos:pos + size].reshape(
                            self.leaf_shapes[i]).clone()
                        flat_state[i] = d
                        pos += size
                    off += b.lb
        out = {k: {} for k in self.layer_keys}
        for i, (layer, pname) in enumerate(self.leaf_keys):
            s = flat_state[i]
            if s is None:
                fr = self.frozen_rules[i]
                s = (fr.init_one(torch.zeros(self.leaf_shapes[i],
                                             dtype=self.leaf_dtypes[i],
                                             device=self.device))
                     if fr is not None else {})
            out[layer][pname] = s
        return out

    def check_state(self, opt_state) -> None:
        """Refuse a sharded state that is not this layout's (another
        worker count must be re-sharded, not mis-sliced)."""
        if not is_zero_state(opt_state):
            raise ValueError("not a zero sharded opt state")
        st = opt_state[ZERO_STATE_KEY]
        if len(st) != len(self.groups):
            raise ValueError(
                f"zero state has {len(st)} groups, layout has "
                f"{len(self.groups)} — re-shard it for this mesh")
        for g, s in zip(self.groups, st):
            if set(s) != set(g.state_keys):
                raise ValueError(
                    f"zero state keys {sorted(s)} != layout "
                    f"{sorted(g.state_keys)}")
            for key, v in s.items():
                if tuple(v.shape) != (self.local, g.length):
                    raise ValueError(
                        f"zero state leaf {key} has shape "
                        f"{tuple(v.shape)}, layout wants "
                        f"{(self.local, g.length)} — state saved on a "
                        f"different mesh size must be re-sharded "
                        f"(make_zero_resharder)")

    def reshard_state_leaf(self, gi: int, old: torch.Tensor,
                           old_n: int) -> torch.Tensor:
        """One group's state saved for ``old_n`` workers re-sliced into
        this layout: a bucket at a time, the old padding cut off and the
        new added."""
        g = self.groups[gi]
        old_lbs = [-(-b.nb // old_n) for b in g.buckets]
        if tuple(old.shape) != (old_n, sum(old_lbs)):
            raise ValueError(
                f"state array shape {tuple(old.shape)} does not match an "
                f"{old_n}-shard layout of group {gi} "
                f"({(old_n, sum(old_lbs))})")
        rows, off = [], 0
        for b, old_lb in zip(g.buckets, old_lbs):
            flat = old[:, off:off + old_lb].reshape(old_n * old_lb)[:b.nb]
            pad = self.n * b.lb - b.nb
            if pad:
                flat = torch.cat([flat, flat.new_zeros((pad,))])
            rows.append(flat.reshape(self.n, b.lb))
            off += old_lb
        return torch.cat(rows, dim=1)

    # -------------------------------------------------------- profiling
    def profile(self, mesh: Optional[Mesh] = None, repeats: int = 3) -> dict:
        """Time this stage's gradient collective a bucket (stage 2's
        reduce-scatter, ``reduce_scatter`` spans; stage 1's all-reduce and
        slice, ``grad_allreduce``) and each group's all-gather, on zero
        buffers of the padded shapes (best of ``repeats``: CUDA events on
        the card, ``perf_counter`` on the CPU); record each as a
        cat "collective" span, the gathers under a ``zero.allgather``
        span; set ``zero.reduce_scatter_ms`` and ``zero.allgather_ms`` and
        refresh the ``zero.*`` gauges. A row's ``bytes`` is the padded
        buffer the collective moves. The mesh is logical: the times are the
        kernels and copies on the one device, not a wire. Host-side
        tooling; the training step never calls it."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("profile() needs a mesh")
        reg = get_registry()
        n, axis, dev = self.n, self.axis, mesh.device
        reduce_name = "reduce_scatter" if self.stage == 2 else \
            "grad_allreduce"

        local = local_count(mesh, axis)

        def scat(buf, lb):
            if self.stage == 1:
                return pmean(buf, mesh, axis)[0].view(n, lb)
            return psum_scatter(buf.view(local, n, lb), mesh, axis) / n

        rows = {"reduce_scatter": [], "all_gather": []}
        rs_ms = 0.0
        for gi, g in enumerate(self.groups):
            for bi, b in enumerate(g.buckets):
                buf = torch.zeros((local, n * b.lb), dtype=g.dtype,
                                  device=dev)
                ms = time_collective(lambda: scat(buf, b.lb), dev, repeats)
                rs_ms += ms
                nbytes = n * b.lb * _itemsize(g.dtype)
                rows["reduce_scatter"].append(
                    {"group": gi, "bucket": bi, "bytes": nbytes,
                     "ms": round(ms, 4)})
                record_external_span(reduce_name, ms, cat="collective",
                                     bucket=bi, group=gi, bytes=nbytes)
        ag_ms = 0.0
        with span("zero.allgather", groups=len(self.groups)):
            for gi, g in enumerate(self.groups):
                buf = torch.zeros((local, g.length), dtype=g.dtype,
                                  device=dev)
                ms = time_collective(lambda: all_gather(buf, mesh, axis),
                                     dev, repeats)
                ag_ms += ms
                nbytes = g.length * n * _itemsize(g.dtype)
                rows["all_gather"].append(
                    {"group": gi, "bytes": nbytes, "ms": round(ms, 4)})
                record_external_span("all_gather", ms, cat="collective",
                                     group=gi, bytes=nbytes)
        self._publish_gauges()
        if reg.enabled:
            reg.gauge("zero.reduce_scatter_ms").set(rs_ms)
            reg.gauge("zero.allgather_ms").set(ag_ms)
        return {"reduce_scatter": rows["reduce_scatter"],
                "all_gather": rows["all_gather"],
                "reduce_scatter_ms": round(rs_ms, 4),
                "allgather_ms": round(ag_ms, 4),
                "shard_state_bytes": self.shard_state_bytes,
                "replicated_state_bytes": self.replicated_state_bytes}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def make_zero_resharder(engine: ZeroUpdateEngine):
    """A ``resharder`` for ``restore_latest_sharded_checkpoint``: when a
    checkpoint's ``sharding`` block describes another worker count than
    ``engine``'s layout, the whole tree is assembled on the host and every
    ZeRO state leaf re-sliced for this layout (the other leaves must match
    ``like``'s shapes). Returns None when the saved layout already matches
    (the caller restores as it is)."""

    def _reshard(directory: str, step: int, like, manifest: dict):
        from ..util.distributed_checkpoint import (load_checkpoint_arrays,
                                                   tree_flatten,
                                                   tree_unflatten)
        from .tensor_parallel import fits, place_like
        meta = (manifest or {}).get("sharding")
        if not meta or meta.get("format") != "zero-flat":
            return None
        if engine.meta_matches(meta):
            return None
        mine = engine.sharding_meta()
        if [g["bucket_elems"] for g in meta.get("groups", [])] != \
                [g["bucket_elems"] for g in mine["groups"]]:
            raise ValueError(
                "checkpoint zero layout has different group bucketing "
                "than the current engine (different net or bucket_bytes) "
                "— cannot re-shard")
        old_n = int(meta["num_shards"])
        saved = load_checkpoint_arrays(directory, step)
        like_leaves, spec = tree_flatten(like)
        if len(saved) != len(like_leaves):
            raise ValueError(
                f"checkpoint has {len(saved)} leaves; 'like' tree "
                f"has {len(like_leaves)}")
        # the zero state's leaves come in group order, one a state name:
        # the only leaves whose shapes may differ from ``like``
        expected = [gi for gi, g in enumerate(engine.groups)
                    for _ in g.state_keys]
        out, zi = [], 0
        for arr, lk in zip(saved, like_leaves):
            if not fits(lk.shape, arr.shape):
                if zi >= len(expected):
                    raise ValueError(
                        f"unexpected shape mismatch: checkpoint "
                        f"{tuple(arr.shape)} vs like {tuple(lk.shape)}")
                arr = engine.reshard_state_leaf(expected[zi], arr, old_n)
                zi += 1
                if not fits(lk.shape, arr.shape):
                    raise ValueError(
                        f"re-sharded state {tuple(arr.shape)} still does "
                        f"not match like {tuple(lk.shape)}")
            out.append(place_like(arr.to(dtype=lk.dtype), lk))
        return tree_unflatten(spec, out)

    return _reshard
