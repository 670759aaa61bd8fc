"""Sharded checkpoints of a training state on the logical mesh.

Counterpart of ``deeplearning4j_tpu/util/distributed_checkpoint.py``:
``save_sharded_checkpoint`` (``:49-125``), ``list_sharded_checkpoints``,
``is_complete``, ``read_manifest``, ``is_valid`` and
``latest_sharded_step`` (``:128-208``),
``restore_latest_sharded_checkpoint`` with its ``resharder`` (``:211-256``),
``load_checkpoint_arrays`` (``:259-314``), ``restore_sharded_checkpoint``
(``:317-382``) and ``DistributedCheckpointer`` (``:385-426``).

The files keep the reference's layout, so either package restores the
other's save: one ``ckpt_step{S}_p000.npz`` (this process's blocks) and a
JSON manifest ``ckpt_step{S}.json`` written last by atomic rename (a save
is valid once its manifest and every process's file exist and read as
archives). The npz holds, a leaf ``i``, blocks ``l{i}_s{j}`` with their
index ``l{i}_s{j}_idx`` ((start, stop) a dimension). The manifest holds
the step, the process count, each leaf's shape and dtype (numpy's names;
bfloat16 is stored as 2-byte raw values, as numpy writes ml_dtypes'),
the caller's ``extra`` and the ZeRO engine's ``sharding`` block.

A tree is nested dicts, lists and tuples of tensors; its leaves are taken
in ``jax.tree.leaves``' order (a dict's keys sorted, None holding no
leaf), so a port tree and a JAX tree of the same structure line up. A
leaf sharded on the data axis is a per-worker ``[n, ...]`` tensor on the
logical mesh: the leaves of a ZeRO state (``parallel/zero.py``, a dict
``{"_zero_": ...}``) are stored one block a worker row, as the reference
stores an array sharded on the data axis; every other leaf is one block,
as a replicated array is stored once. A leaf laid out on a model axis
(per-rank rows, ``parallel/tensor_parallel.py``; the save's ``specs``
say which, ``tensor_parallel.tree_specs``) is stored under its global
shape, one block a rank at that rank's slice of the cut dimension, as the
reference stores a model-sharded array. A restore assembles each leaf
from its blocks, checks it against the ``like`` tree's leaf (its shape,
or the rows of it, and its dtype), puts it on ``like``'s device and cuts
it into ``like``'s rows where ``like`` holds rows; a save for another
worker count fails that check (a ``resharder``,
``parallel.zero.make_zero_resharder`` or
``parallel.resharding.make_any_resharder``, re-slices it instead).
"""
from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.tensor_parallel import (fits, full, global_shape, is_rows,
                                       place_like, spec_dim)
from ..parallel.zero import ZERO_STATE_KEY, dtype_name

_log = logging.getLogger("deeplearning4j_tpu_torch")

_MANIFEST_RE = re.compile(r"^ckpt_step(\d+)\.json$")

_NP_TO_TORCH = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16,
                "int64": torch.int64, "int32": torch.int32,
                "int16": torch.int16, "int8": torch.int8,
                "uint8": torch.uint8, "bool": torch.bool}


# --------------------------------------------------------------- trees
def _flatten(tree, rows: bool, out: list, flags: list):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        flags.append(rows)
        return "*"
    if tree is None:
        return None
    if isinstance(tree, dict):
        sub = rows or set(tree) == {ZERO_STATE_KEY}
        keys = sorted(tree)
        return ("dict", keys, [_flatten(tree[k], sub, out, flags)
                               for k in keys])
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, None,
                [_flatten(v, rows, out, flags) for v in tree])
    raise TypeError(f"a checkpoint tree holds tensors, dicts, lists and "
                    f"tuples, not {type(tree).__name__}")


def _spec_leaves(tree, specs, out: list) -> list:
    """The spec of each of ``tree``'s leaves in ``_flatten``'s order, from
    its layout tree ``specs`` (None: every leaf whole)."""
    if isinstance(tree, torch.Tensor):
        out.append(specs or ())
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _spec_leaves(tree[k], None if specs is None else specs[k], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _spec_leaves(v, None if specs is None else specs[i], out)
    return out


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(leaves in ``jax.tree.leaves``' order, the structure)."""
    out, flags = [], []
    spec = _flatten(tree, False, out, flags)
    return out, spec


def tree_unflatten(spec, leaves: List[torch.Tensor]):
    """The tree of ``spec`` (from ``tree_flatten``) over ``leaves``."""
    it = iter(leaves)

    def build(s):
        if s == "*":
            return next(it)
        if s is None:
            return None
        kind, keys, subs = s
        vals = [build(v) for v in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        return tuple(vals) if kind == "tuple" else list(vals)

    return build(spec)


# ------------------------------------------------------------- blocks
def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(block: np.ndarray, name: str) -> torch.Tensor:
    target = _NP_TO_TORCH[name]
    if block.dtype.kind == "V" or (target == torch.bfloat16
                                   and block.dtype.itemsize == 2):
        raw = torch.from_numpy(np.ascontiguousarray(block).view(np.int16))
        return raw.view(torch.bfloat16) if target == torch.bfloat16 \
            else raw.view(target)
    return torch.from_numpy(np.ascontiguousarray(block)).to(target)


def _atomic_write(directory: str, final: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_sharded_checkpoint(directory: str, step: int, tree: Any,
                            extra: Optional[Dict[str, Any]] = None,
                            sharding: Optional[Dict[str, Any]] = None,
                            specs: Any = None) -> str:
    """Write ``tree``'s blocks and the manifest (see the module docstring);
    returns the manifest's path. ``extra`` (the caller's resume position)
    and ``sharding`` (the ZeRO engine's layout) are stored in the manifest
    as given; ``specs`` is the tree's model-axis layout (a tree of specs,
    ``tensor_parallel.tree_specs``; None: no leaf is rows)."""
    os.makedirs(directory, exist_ok=True)
    leaves, rows = [], []
    _flatten(tree, False, leaves, rows)
    cuts = _spec_leaves(tree, specs, [])
    payload = {}
    meta_leaves = []
    for i, (leaf, by_row, spec) in enumerate(zip(leaves, rows, cuts)):
        shape = global_shape(leaf, spec)
        meta_leaves.append({"shape": list(shape),
                            "dtype": dtype_name(leaf.dtype)})
        if is_rows(leaf, spec):         # a model axis' rows: a block a rank
            cut = spec_dim(spec)
            k = shape[cut] // leaf.shape[0]
            blocks = [tuple((r * k, (r + 1) * k) if j == cut else (0, d)
                            for j, d in enumerate(shape))
                      for r in range(leaf.shape[0])]
        elif by_row and leaf.dim() >= 1:
            blocks = [((k, k + 1),) + tuple((0, d) for d in shape[1:])
                      for k in range(shape[0])]
        else:
            blocks = [tuple((0, d) for d in shape)]
        host = _to_numpy(full(leaf, spec))
        for j, idx in enumerate(blocks):
            payload[f"l{i}_s{j}"] = host[tuple(slice(a, b) for a, b in idx)]
            payload[f"l{i}_s{j}_idx"] = (
                np.asarray(idx, np.int64).reshape(len(shape), 2)
                if shape else np.zeros((0, 2), np.int64))
    data_path = os.path.join(directory, f"ckpt_step{step}_p000.npz")

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **payload)

    _atomic_write(directory, data_path, write_npz)
    manifest = os.path.join(directory, f"ckpt_step{step}.json")
    meta = {"step": step, "num_processes": 1, "n_leaves": len(leaves),
            "leaves": meta_leaves, "extra": dict(extra or {})}
    if sharding is not None:
        meta["sharding"] = dict(sharding)

    def write_manifest(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f)

    _atomic_write(directory, manifest, write_manifest)
    return manifest


def list_sharded_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """[(step, manifest path)] ascending (a manifest exists; whether every
    file does is ``is_complete``)."""
    out = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = _MANIFEST_RE.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _shard_files(directory: str, step: int) -> List[str]:
    npz_re = re.compile(rf"^ckpt_step{step}_p(\d+)\.npz$")
    return sorted(os.path.join(directory, n) for n in os.listdir(directory)
                  if npz_re.match(n))


def is_complete(directory: str, step: int) -> bool:
    """The manifest and every process's file exist."""
    manifest = os.path.join(directory, f"ckpt_step{step}.json")
    if not os.path.exists(manifest):
        return False
    try:
        with open(manifest) as f:
            n_expected = int(json.load(f)["num_processes"])
    except (OSError, ValueError, KeyError):
        return False
    return len(_shard_files(directory, step)) >= n_expected


def read_manifest(directory: str, step: int) -> Optional[dict]:
    """The manifest of ``step`` (its ``extra`` included), or None."""
    try:
        with open(os.path.join(directory, f"ckpt_step{step}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_valid(directory: str, step: int) -> bool:
    """``is_complete`` and every file a readable archive (a truncated npz
    loses its central directory, which ``zipfile.is_zipfile`` sees without
    reading the payload)."""
    if not is_complete(directory, step):
        return False
    for path in _shard_files(directory, step):
        try:
            if not zipfile.is_zipfile(path):
                return False
        except OSError:
            return False
    return True


def latest_sharded_step(directory: str) -> Optional[int]:
    """The newest complete and valid step, or None."""
    for step, _ in reversed(list_sharded_checkpoints(directory)):
        if is_valid(directory, step):
            return step
    return None


def restore_latest_sharded_checkpoint(directory: str, like: Any,
                                      resharder=None
                                      ) -> Tuple[Optional[int], Any, dict]:
    """The newest save that restores, walking back past incomplete,
    truncated or corrupt ones: ``(step, tree, extra)``, or
    ``(None, like, {})``. ``resharder(directory, step, like, manifest)``
    is asked first for every candidate: a tree re-sliced for this layout,
    or None to restore as it is; its failure falls back to an older save
    like any other."""
    for step, _ in reversed(list_sharded_checkpoints(directory)):
        if not is_valid(directory, step):
            _log.warning("checkpoint step %d in %s is incomplete/truncated; "
                         "falling back to an older save", step, directory)
            continue
        manifest = read_manifest(directory, step) or {}
        try:
            tree = None
            if resharder is not None:
                tree = resharder(directory, step, like, manifest)
            if tree is None:
                tree = restore_sharded_checkpoint(directory, step, like)
        except Exception as e:   # corrupt member, CRC, layout mismatch
            _log.warning("checkpoint step %d in %s failed to restore (%s); "
                         "falling back to an older save", step, directory, e)
            continue
        return step, tree, dict(manifest.get("extra") or {})
    return None, like, {}


def load_checkpoint_arrays(directory: str, step: int) -> List[torch.Tensor]:
    """Every leaf of the save at ``step`` assembled whole on the host (CPU
    tensors, the manifest's dtypes) from all processes' blocks; raises if
    a block is missing."""
    with open(os.path.join(directory, f"ckpt_step{step}.json")) as f:
        manifest = json.load(f)
    files = _shard_files(directory, step)
    if not files:
        raise FileNotFoundError(f"no shard files for step {step} in "
                                f"{directory!r}")
    n = manifest["n_leaves"]
    out: List[Optional[torch.Tensor]] = [None] * n
    covered = [0] * n
    seen: List[set] = [set() for _ in range(n)]
    key_re = re.compile(r"^l(\d+)_s(\d+)_idx$")
    for path in files:
        with np.load(path) as z:
            for key in z.files:
                m = key_re.match(key)
                if not m:
                    continue
                i = int(m.group(1))
                meta = manifest["leaves"][i]
                idx = tuple(tuple(int(v) for v in row) for row in z[key])
                if idx in seen[i]:       # a replicated duplicate
                    continue
                seen[i].add(idx)
                block = _from_numpy(z[key[:-4]], meta["dtype"])
                if out[i] is None:
                    out[i] = torch.zeros(tuple(meta["shape"]),
                                         dtype=_NP_TO_TORCH[meta["dtype"]])
                out[i][tuple(slice(a, b) for a, b in idx)] = block
                size = 1
                for a, b in idx:
                    size *= b - a
                covered[i] += size
    for i, meta in enumerate(manifest["leaves"]):
        size = 1
        for d in meta["shape"]:
            size *= int(d)
        if out[i] is None and size:
            raise ValueError(f"leaf {i}: no blocks found")
        if out[i] is None:
            out[i] = torch.zeros(tuple(meta["shape"]),
                                 dtype=_NP_TO_TORCH[meta["dtype"]])
        if covered[i] < size:
            raise ValueError(
                f"leaf {i}: blocks cover {covered[i]} of {size} elements "
                f"— shard file missing? (host assembly needs shared "
                f"storage)")
    return out


def restore_sharded_checkpoint(directory: str, step: int, like: Any) -> Any:
    """The tree saved at ``step``, shaped as ``like`` (its structure; each
    leaf's shape and dtype checked and its device taken)."""
    with open(os.path.join(directory, f"ckpt_step{step}.json")) as f:
        manifest = json.load(f)
    leaves, spec = tree_flatten(like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves; "
                         f"'like' tree has {len(leaves)}")
    for i, leaf in enumerate(leaves):
        meta = manifest["leaves"][i]
        if not fits(leaf.shape, meta["shape"]) or \
                dtype_name(leaf.dtype) != meta["dtype"]:
            raise ValueError(
                f"leaf {i}: checkpoint {meta['shape']}/{meta['dtype']} vs "
                f"like {list(leaf.shape)}/{dtype_name(leaf.dtype)} — was "
                f"the checkpoint written on a different mesh topology?")
    arrays = load_checkpoint_arrays(directory, step)
    return tree_unflatten(spec, [place_like(a, l) for a, l in
                                 zip(arrays, leaves)])


class DistributedCheckpointer:
    """Periodic sharded checkpoints for a mesh training loop: a save every
    ``every_n_steps``, the newest ``keep_last`` kept, a resume from the
    newest save that restores (the mesh counterpart of
    ``CheckpointListener``)."""

    def __init__(self, directory: str, every_n_steps: int = 100,
                 keep_last: int = 2):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.every_n_steps = max(1, every_n_steps)
        self.keep_last = keep_last

    def maybe_save(self, step: int, tree: Any) -> bool:
        if step % self.every_n_steps:
            return False
        self.save(step, tree)
        return True

    def save(self, step: int, tree: Any):
        save_sharded_checkpoint(self.directory, step, tree)
        self._prune()

    def latest(self) -> Optional[int]:
        return latest_sharded_step(self.directory)

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        """(step, tree) from the newest save that restores, or
        (None, like)."""
        step, tree, _ = restore_latest_sharded_checkpoint(self.directory, like)
        return step, tree

    def _prune(self):
        """Keep the newest ``keep_last`` complete saves. An incomplete save
        does not count; one older than the newest kept is removed, a newer
        one is left (another process may be writing it)."""
        all_steps = [s for s, _ in list_sharded_checkpoints(self.directory)]
        complete = [s for s in all_steps if is_complete(self.directory, s)]
        keep = set(complete[-self.keep_last:])
        if not keep:
            return
        newest_kept = max(keep)
        for step in all_steps:
            if step in keep or step > newest_kept:
                continue
            manifest = os.path.join(self.directory, f"ckpt_step{step}.json")
            if os.path.exists(manifest):
                os.unlink(manifest)    # the manifest first: the save is void
            for path in _shard_files(self.directory, step):
                os.unlink(path)
