"""Any layout to any layout: redistribution of a live tree and of a
sharded checkpoint.

Counterpart of ``deeplearning4j_tpu/parallel/resharding.py``
(``redistribute`` ``:46-55``, ``_host_reshard`` ``:58-84``,
``make_any_resharder`` ``:87-120``). A checkpoint written under any
layout (a 1-D data mesh, a ``(data, model)`` mesh whose sharded leaves are
per-rank rows, a ZeRO flat state) restores onto any other (arXiv
2112.01075: redistribution is a gather and a re-slice):

- the same layout restores block by block
  (``util/distributed_checkpoint.py`` ``restore_sharded_checkpoint``),
  bitwise;
- another layout assembles every leaf whole on the host
  (``load_checkpoint_arrays``, the gather) and cuts it into the target's
  rows where the target holds rows (the slice);
- a ZeRO flat state keeps its own resharder (its ``[n, L]`` layout needs
  the buckets re-padded, not a plain re-slice): a save whose manifest
  carries the ``zero-flat`` block delegates to
  ``parallel.zero.make_zero_resharder``.

On the logical mesh every rank's rows live in one process, so the gather
is a join in rank order and nothing is partly addressable.
"""
from __future__ import annotations

from typing import Any, Optional

from .mesh import Mesh
from .tensor_parallel import (fits, full, model_axis_size, place_like,
                              spec_dim, split_rows)
from .zero import make_zero_resharder


def redistribute(tree: Any, mesh: Mesh, specs: Any,
                 layout: Any = None) -> Any:
    """``tree`` laid out by ``specs`` (a tree of the same structure, a spec
    a leaf) on ``mesh``'s model axis: a leaf whose spec cuts a dimension
    becomes that dimension's rows, any other leaf whole. ``layout`` is
    the tree's own layout now (a tree of specs, as
    ``tensor_parallel.tree_specs`` gives; None: every leaf whole). The
    values do not change (pure layout)."""
    m = model_axis_size(mesh)

    def per(leaf, spec, held):
        whole = full(leaf, held or ()).detach()
        d = spec_dim(spec)
        return split_rows(whole, m, d) if d is not None and m > 1 \
            else whole.clone()

    def walk(t, s, h):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], None if h is None else h[k])
                    for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(a, b, None if h is None else c) for a, b, c
                           in zip(t, s, h if h is not None else [None] *
                                  len(t)))
        return per(t, s, h)
    return walk(tree, specs, layout)


def _host_reshard(directory: str, step: int, like: Any) -> Any:
    """Every saved leaf assembled whole on the host, then laid out as
    ``like``'s leaf (cast to its dtype, on its device, cut into its rows).
    Raises (so the restore walks back to an older save) when a global
    shape disagrees, which is also how a ZeRO flat save for another
    worker count shows when no engine was given to read it."""
    from ..util.distributed_checkpoint import (load_checkpoint_arrays,
                                               tree_flatten, tree_unflatten)
    arrs = load_checkpoint_arrays(directory, step)
    leaves, spec = tree_flatten(like)
    if len(arrs) != len(leaves):
        raise ValueError(f"checkpoint has {len(arrs)} leaves; 'like' "
                         f"tree has {len(leaves)}")
    out = []
    for i, (leaf, arr) in enumerate(zip(leaves, arrs)):
        if not fits(leaf.shape, arr.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {tuple(arr.shape)} vs like "
                f"{tuple(leaf.shape)} — layout needs a format-aware "
                f"resharder (zero-flat state from a different data-axis "
                f"size?)")
        out.append(place_like(arr.to(leaf.dtype), leaf))
    return tree_unflatten(spec, out)


def make_any_resharder(zero_engine: Optional[Any] = None):
    """The restore hook for ``restore_latest_sharded_checkpoint``:
    ``(directory, step, like, manifest) -> tree``. For each candidate save:

    1. a ``zero-flat`` layout with an engine given: the ZeRO resharder
       (its None means the layout already matches, which falls through);
    2. the block restore, bitwise whenever the save's layout is
       ``like``'s;
    3. the host gather and re-slice: any saved layout onto ``like``'s.

    An exception goes to the caller's walk-back, so a corrupt or
    unreadable newest save falls back to an older one."""
    zero_hook = (make_zero_resharder(zero_engine)
                 if zero_engine is not None else None)

    def _reshard(directory: str, step: int, like: Any, manifest: dict):
        from ..util.distributed_checkpoint import restore_sharded_checkpoint
        layout = (manifest or {}).get("sharding") or {}
        if zero_hook is not None and layout.get("format") == "zero-flat":
            tree = zero_hook(directory, step, like, manifest)
            if tree is not None:
                return tree
        try:
            return restore_sharded_checkpoint(directory, step, like)
        except ValueError:
            # another layout: the portable gather and re-slice
            pass
        return _host_reshard(directory, step, like)

    return _reshard

