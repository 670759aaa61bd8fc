"""Megatron tensor parallelism on the ``model`` axis of a logical mesh.

Counterpart of ``deeplearning4j_tpu/parallel/tensor_parallel.py``: the rule
table (``_attn_spec`` ``:46-60``, ``_ff_spec`` ``:63-73``, ``_lstm_spec``
``:76-85``), ``model_axis_size`` (``:34-39``), ``build_param_specs``
(``:88-124``), ``build_param_shardings`` (``:127-132``),
``build_opt_shardings`` (``:135-149``), ``sharded_leaf_count``
(``:152-155``), ``shard_params`` (``:158-163``), ``host_gather``
(``:166-181``) and ``per_replica_bytes`` (``:184-196``). The split is the
standard one (arXiv 1909.08053): attention Q/K/V column-parallel and the
output projection row-parallel, MLP ff1 column- and ff2 row-parallel, the
LSTM's 4H gate columns column-parallel, everything else replicated. A spec
is a tuple a dimension (``(None, "model")``, ``("model",)``; ``()`` is
replicated), the entries of the reference's ``PartitionSpec``.

In the reference these specs are GSPMD layout hints: XLA inserts every
collective and the math is the replicated network's. Nothing inserts
collectives on the logical mesh, so the port does Megatron explicitly:

- **Storage.** A leaf the rules shard is held as per-rank rows ``[m,
  ...]``, cut along the rule's dimension (``Sharding.split``). The
  network's parameter IS the rows tensor, so a training step reads and
  updates only the rows, and the updater state of a sharded leaf is rows
  too (``place_net``, as ``build_opt_shardings`` shards it).
  ``per_replica_bytes`` counts one rank's rows; ``host_gather`` joins
  them.
- **The layout is the shape**, and this module owns it: rows have one
  more dimension than the global leaf their spec describes
  (``is_rows``), and which leaves can be rows, and along which
  dimension, is the rule table's (``held_specs`` reads a network's
  layout off its shapes, ``state_specs`` its updater state's,
  ``tree_specs`` a checkpoint tree's). Nothing is stored beside the
  tensors, so a copy keeps the layout. A bare tree of tensors does not
  say which of its leaves are rows, so the functions on such trees
  (``host_gather``, ``per_replica_bytes``, the checkpoint's save) take
  its layout; a restore reads it off the ``like`` tree's shapes against
  the saved global shapes (``rows_cut``).
- **One forward, rank-generic.** A whole leaf is one rank's rows
  (``column`` and ``partial_sum`` on a whole W are the plain products),
  so every layer runs one path whatever the layout:
  ``SelfAttentionLayer`` takes each rank's heads from its Q/K/V column
  rows (the flash kernels launched once over every rank's heads, which
  are independent), multiplies each rank's output block by its rows of
  Wo and adds the partials in rank order (``partial_sum``,
  ``mesh.sum_rows``), then the bias; ``DenseLayer`` is column-parallel
  (its bias rows added a rank at a time, the blocks side by side) unless
  its W is row rows, then row-parallel (the input's rank blocks, a sum in
  rank order, then the replicated bias).
  Gradients reach the rows through autograd; a replicated leaf gets one
  gradient, the sum over the ranks that used it.
- **Gather, then compute** where no rank can run its shard alone: an
  LSTM's ``W/R/b`` cut over 4H split whole gate blocks, not units, and a
  Wq whose head count the model axis does not divide cuts heads apart
  (the reference shards both: "GSPMD is correct either way", ``:49-52``).
  Such a layer joins the rows in rank order (``full``) before it runs (the
  LSTM kernels see the whole W and R) and its gradient goes back to the
  rows as a slice. Memory is sharded at rest and the compute replicated,
  which is what GSPMD gives there; it is the one place the per-rank
  compute differs from a rank-local Megatron layout.

At m = 1 the spec table is empty: no leaf becomes rows and the
rank-generic path is the plain ops, so a ``(d, 1)`` mesh is bitwise
``(d,)``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .mesh import Mesh, Sharding, _tree_map, spec_axis, sum_rows

MODEL_AXIS = "model"

_LSTM_LAYER_TYPES = ("GravesLSTM", "LSTM", "GravesBidirectionalLSTM")

REPLICATED: Tuple = ()
COLUMN: Tuple = (None, MODEL_AXIS)
ROW: Tuple = (MODEL_AXIS, None)
VECTOR: Tuple = (MODEL_AXIS,)


def model_axis_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``model`` axis (1 for a 1-D mesh or None)."""
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 1
    return int(mesh.shape[MODEL_AXIS])


# ------------------------------------------------------------ rows
# A leaf's layout is its shape: rows have one more dimension than the
# global leaf whose spec cuts them. Nothing is stored beside the tensors,
# so a copy (a clone, a cast, a gathered ZeRO state) keeps the layout.
def is_rows(t: torch.Tensor, spec) -> bool:
    """Whether ``t`` is the rows of a leaf laid out by ``spec``: the spec
    cuts a dimension and ``t`` has one more dimension than the spec."""
    return spec_dim(spec) is not None and t.dim() == len(spec) + 1


def split_rows(t: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    """The global leaf ``t`` as m rows ``[m, ...]`` cut along ``dim`` (a
    copy)."""
    if t.shape[dim] % m:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"divide over a model axis of {m}")
    return torch.stack(t.chunk(m, dim=dim)).contiguous()


def full(t: torch.Tensor, spec) -> torch.Tensor:
    """The global leaf of ``t`` laid out by ``spec``: its rows joined in
    rank order (a differentiable all-gather, so the gradient reaches each
    rank's rows as its slice), or ``t`` itself when it is whole."""
    if not is_rows(t, spec):
        return t
    return torch.cat(t.unbind(0), dim=spec_dim(spec))


def global_shape(t: torch.Tensor, spec) -> Tuple[int, ...]:
    """The shape of the global leaf of ``t`` laid out by ``spec``."""
    if not is_rows(t, spec):
        return tuple(t.shape)
    shape = list(t.shape[1:])
    shape[spec_dim(spec)] *= t.shape[0]
    return tuple(shape)


def rows_cut(shape, whole) -> Optional[int]:
    """The dimension along which a leaf of ``shape`` is the rows of a
    global leaf of shape ``whole``, or None when it is that leaf whole;
    ValueError when it is neither (a restore's layout check)."""
    shape, whole = tuple(shape), tuple(whole)
    if shape == whole:
        return None
    if len(shape) == len(whole) + 1 and shape[0] > 1:
        diff = [d for d, (a, b) in enumerate(zip(shape[1:], whole))
                if a != b]
        if len(diff) == 1 and shape[0] * shape[1 + diff[0]] == \
                whole[diff[0]]:
            return diff[0]
    raise ValueError(f"a leaf of shape {shape} is neither the global leaf "
                     f"{whole} nor its rows")


def fits(shape, whole) -> bool:
    """Whether a leaf of ``shape`` holds a global leaf of shape ``whole``,
    whole or as its rows (``rows_cut``)."""
    try:
        rows_cut(shape, whole)
    except ValueError:
        return False
    return True


def place_like(arr: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The global leaf ``arr`` laid out as ``like`` is: on its device, and
    cut into its rows where ``like`` holds rows of ``arr``'s shape."""
    arr = arr.to(like.device)
    d = rows_cut(like.shape, arr.shape)
    return arr if d is None else split_rows(arr, like.shape[0], d)


def column(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each rank's column block of ``x @ W``: x ``[..., n]`` and column rows
    ``[m, n, k]`` -> ``[m, ..., k]`` (one batched product). A whole W
    ``[n, k]`` is one rank's: ``(x @ W)[None]``, the plain product."""
    if w.dim() == 2:
        return (x @ w).unsqueeze(0)
    m, n, k = w.shape
    return torch.matmul(x.unsqueeze(0),
                        w.view((m,) + (1,) * (x.dim() - 2) + (n, k)))


def partial_sum(h_rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel product: each rank's activation block ``[m, ..., k]``
    times its row rows ``[m, k, n]``, the m partials added in rank order
    (the model axis' psum). A whole W ``[k, n]`` is one rank's:
    ``h_rows[0] @ W``, the plain product."""
    if w.dim() == 2:
        return h_rows[0] @ w
    m, k, n = w.shape
    parts = torch.matmul(h_rows, w.view(
        (m,) + (1,) * (h_rows.dim() - 3) + (k, n)))
    return sum_rows(parts)


def rank_blocks(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x``'s last dimension cut into m rank blocks: ``[..., m*k]`` ->
    ``[m, ..., k]`` (what a column-parallel layer's ranks hold)."""
    shape = tuple(x.shape[:-1])
    return x.reshape(shape + (m, -1)).movedim(-2, 0)


def join_blocks(h: torch.Tensor) -> torch.Tensor:
    """``rank_blocks``' inverse: ``[m, ..., k]`` -> ``[..., m*k]``."""
    return h.movedim(0, -2).flatten(-2)


# ------------------------------------------------------------ rules
def _attn_spec(key: str, shape, m: int) -> Tuple:
    # Wq/Wk/Wv column-parallel (whole heads when n_heads % m == 0; the
    # layer gathers otherwise), Wo row-parallel; the bias rides the
    # post-psum add
    if key in ("Wq", "Wk", "Wv") and len(shape) == 2 and shape[1] % m == 0:
        return COLUMN
    if key == "Wo" and len(shape) == 2 and shape[0] % m == 0:
        return ROW
    return REPLICATED


def _ff_spec(vertex: str, key: str, shape, m: int) -> Tuple:
    if vertex.endswith("_ff1"):
        if key == "W" and len(shape) == 2 and shape[1] % m == 0:
            return COLUMN
        if key == "b" and len(shape) == 1 and shape[0] % m == 0:
            return VECTOR         # adds onto the column-sharded hidden
    if vertex.endswith("_ff2"):
        if key == "W" and len(shape) == 2 and shape[0] % m == 0:
            return ROW
        # ff2's bias adds after the row-parallel psum: replicated
    return REPLICATED


def _lstm_spec(key: str, shape, m: int) -> Tuple:
    # W [n_in, 4H] / R [H, 4H]: the gate blocks' columns, the bias with
    # them; the peepholes replicated
    if key in ("W", "R", "U") and len(shape) == 2 and shape[1] % m == 0:
        return COLUMN
    if key == "b" and len(shape) == 1 and shape[0] % m == 0:
        return VECTOR
    return REPLICATED


def _rule(net):
    """``rule(group, key, shape, m)``: the rule table of ``net``'s kind
    (a graph's vertices by name, a layer stack's LSTMs by type)."""
    if hasattr(net, "vertex_names"):                 # ComputationGraph
        def rule(name, key, shape, m):
            if name.endswith("_attn"):
                return _attn_spec(key, shape, m)
            if name.endswith("_ff1") or name.endswith("_ff2"):
                return _ff_spec(name, key, shape, m)
            return REPLICATED
        return rule
    kinds = {i: type(layer).__name__ for i, layer in enumerate(net.layers)}

    def rule(i, key, shape, m):                      # MultiLayerNetwork
        if kinds[i] in _LSTM_LAYER_TYPES:
            return _lstm_spec(key, shape, m)
        return REPLICATED
    return rule


def held_specs(net) -> Dict[Any, Dict[str, Tuple]]:
    """The layout ``net`` holds now, shaped as ``net.param_dicts()``: the
    rule's spec for a leaf held as its rows, ``()`` for a whole leaf. It
    is read off the shapes: a leaf is rows when the rules could cut it
    (their spec for its row shape, divisibility aside, cuts a dimension)
    and it has one dimension more than that spec."""
    rule = _rule(net)
    out = {}
    for g, pd in net.param_dicts().items():
        out[g] = {}
        for k, p in pd.items():
            spec = rule(g, k, tuple(p.shape[1:]), 1) if p.dim() else ()
            out[g][k] = spec if is_rows(p, spec) else REPLICATED
    return out


def state_specs(net) -> Any:
    """The layout of ``net.opt_state``, shaped as it: a state leaf of its
    parameter's shape (Adam's m and v) is laid out as the parameter, any
    other leaf (and every leaf of a ZeRO-format state) is whole."""
    held, params = held_specs(net), net.param_dicts()

    def walk(t, path):
        if isinstance(t, dict):
            return {key: walk(v, path + (key,)) for key, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path) for v in t)
        if not isinstance(t, torch.Tensor):
            return t
        p = params.get(path[0], {}).get(path[1]) if len(path) > 1 else None
        return held[path[0]][path[1]] if p is not None and \
            t.shape == p.shape else REPLICATED
    return walk(net.opt_state, ())


def specs_by_id(net) -> Dict[int, Tuple]:
    """The spec of each of ``net``'s parameters and updater-state leaves
    as it is held now, by the tensor's ``id``."""
    by_id = {}
    held, params = held_specs(net), net.param_dicts()
    for g, sd in held.items():
        for k, s in sd.items():
            by_id[id(params[g][k])] = s
    _tree_map2(lambda t, s: by_id.setdefault(id(t), s), net.opt_state,
               state_specs(net))
    return by_id


def tree_specs(net, tree) -> Any:
    """The layout of ``tree``, a tree made of ``net``'s parameters and
    updater-state leaves (as a checkpoint's): each leaf's spec (``()``
    for a tensor that is neither)."""
    by_id = specs_by_id(net)
    return _tree_map(lambda t: by_id.get(id(t), REPLICATED), tree)


def build_param_specs(net, m: int) -> Dict[Any, Dict[str, Tuple]]:
    """The spec of every parameter, shaped as ``net.param_dicts()``
    ({group: {name: spec}}). At m = 1 (or a network with nothing the rules
    shard) every spec is ``()``; a leaf whose dimension does not divide by
    m falls back to ``()`` alone. The rules read each leaf's global shape,
    so a network already holding rows gives the same table."""
    if not getattr(net, "initialized", True):
        raise ValueError("net has no params — call net.init() first")
    rule, held = _rule(net), held_specs(net)
    return {g: {k: (rule(g, k, global_shape(p, held[g][k]), m) if m > 1
                    else REPLICATED) for k, p in pd.items()}
            for g, pd in net.param_dicts().items()}


def spec_dim(spec) -> Optional[int]:
    """The dimension a spec cuts, or None for a replicated spec."""
    return spec_axis(spec)[1]


def build_param_shardings(mesh: Mesh, specs) -> Dict:
    """The ``Sharding`` of every parameter (None for a replicated one)."""
    return {g: {k: (None if spec_dim(s) is None
                    else Sharding(mesh, MODEL_AXIS, spec_dim(s)))
                for k, s in sd.items()} for g, sd in specs.items()}


def build_opt_shardings(mesh: Mesh, specs, params, opt_state) -> Dict:
    """The ``Sharding`` of every updater-state leaf, shaped as
    ``opt_state``: a state leaf of its parameter's shape (Adam's m and v)
    takes the parameter's; any other stays replicated (None)."""
    out = {}
    for g, sd in specs.items():
        out[g] = {}
        for k, s in sd.items():
            d = spec_dim(s)
            out[g][k] = {
                sk: (Sharding(mesh, MODEL_AXIS, d) if d is not None
                     and t.shape == params[g][k].shape else None)
                for sk, t in opt_state[g][k].items()}
    return out


def sharded_leaf_count(specs) -> int:
    """How many parameters the rules shard (0 is pure data parallelism)."""
    return sum(1 for sd in specs.values() for s in sd.values() if s != ())


def shard_params(mesh: Mesh, params, specs) -> Dict:
    """A tree shaped as ``params`` (whole leaves) whose leaves the specs
    cut are rows (a redistribution: the values do not change); the other
    leaves are the same tensors."""
    m = model_axis_size(mesh)
    return {g: {k: (split_rows(v.detach(), m, spec_dim(specs[g][k]))
                    if spec_dim(specs[g][k]) is not None and m > 1 else v)
                for k, v in pd.items()} for g, pd in params.items()}


def host_gather(tree, specs=None) -> Any:
    """The tree with every rows leaf joined to its global leaf, detached,
    on the host (CPU tensors): what ``write_model`` and the resharder
    write. ``specs`` is the tree's layout (``tree_specs``; None: every
    leaf whole). Every rank's rows live in this process on the logical
    mesh, so no leaf is partly addressable."""
    return _tree_map2(lambda t, s: full(t, s).detach().cpu(), tree, specs)


def per_replica_bytes(tree, specs=None) -> int:
    """Bytes of ``tree`` one rank holds: a rows leaf counts its one row, a
    whole leaf all of it (the figure the m-fold reduction is read from).
    ``specs`` is the tree's layout (``tree_specs``; None: every leaf
    whole)."""
    sizes = []
    _tree_map2(lambda t, s: sizes.append(
        t.numel() * t.element_size() // (t.shape[0] if is_rows(t, s)
                                         else 1)), tree, specs)
    return sum(sizes)


def _tree_map2(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its layout tree ``specs``
    (None: every leaf whole)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs or REPLICATED)
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, None if specs is None else specs[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map2(fn, v, None if specs is None else s)
                          for v, s in zip(tree, specs if specs is not None
                                          else [None] * len(tree)))
    return tree


# ------------------------------------------------------ the network
def _owner(net, group, name) -> nn.Module:
    """The module whose own parameter ``name`` is the leaf of ``group``."""
    p = net.param_dicts()[group][name]
    for mod in net.modules():
        if mod._parameters.get(name) is p:
            return mod
    raise KeyError(f"no module owns parameter {group}.{name}")


@torch.no_grad()
def place_net(net, m: int) -> int:
    """Lay ``net``'s parameters and updater state out for a model axis of
    ``m`` in place: a leaf the rules shard becomes its rows, any other leaf
    (every leaf at m = 1) becomes whole again; the values do not change.
    Returns the number of sharded leaves. A ZeRO-format updater state
    (``parallel/zero.py``) is refused: it is laid out after this."""
    from .zero import is_zero_state
    specs, held = build_param_specs(net, m), held_specs(net)
    params = net.param_dicts()
    moves = [(g, k, s) for g, sd in specs.items() for k, s in sd.items()
             if not (held[g][k] == s and (
                 spec_dim(s) is None or params[g][k].shape[0] == m))]
    if moves and is_zero_state(net.opt_state):
        raise ValueError("the updater state is in the ZeRO sharded format; "
                         "gather it (ParallelWrapper.gather_opt_state) "
                         "before changing the model axis")
    opt = net.opt_state
    for g, k, s in moves:
        p, d = params[g][k], spec_dim(s)
        whole = full(p, held[g][k]).detach()
        new = whole if d is None else split_rows(whole, m, d)
        setattr(_owner(net, g, k), k,
                nn.Parameter(new, requires_grad=p.requires_grad))
        if opt is not None and g in opt and k in opt[g]:
            st = opt[g][k]
            for sk, t in list(st.items()):
                if t.shape != p.shape:
                    continue            # not laid out as the parameter
                tw = full(t, held[g][k]).detach()
                st[sk] = tw.clone() if d is None else split_rows(tw, m, d)
    return sharded_leaf_count(specs)
