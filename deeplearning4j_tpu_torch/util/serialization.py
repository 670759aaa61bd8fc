"""Model persistence: the model zip.

Counterpart of ``deeplearning4j_tpu/util/serialization.py``. A zip holds
five entries, as the reference's does:
- ``configuration.json``: the configuration's JSON (``nn/conf/serde.py``);
- ``coefficients.bin``: every parameter as one flat float32 buffer, in
  ``jax.tree.leaves(net.params)``'s order (vertices or layers in order,
  each one's parameter names sorted: ``parallel.data_parallel.
  flat_param_order``);
- ``updaterState.bin``: the updater state the same way, each parameter's
  state names sorted (``flat_opt_state_order``);
- ``state.bin``: the layer state (a BatchNormalization's running ``mean``
  and ``var``) the same way (``flat_state_order``), empty for a network
  without any;
- ``manifest.json``: the format, the model class, the sizes and the
  iteration count.

So a zip written by either package restores in the other, bytes for
bytes. Everything is written as float32; a restored network takes its
configuration's dtype and lives on ``device`` (the CUDA card unless the
caller names another). ``restore_model`` sniffs a model zip, a Java
DL4J zip (``interop/dl4j_zip.py``), a bare configuration JSON or a Keras
HDF5 file (``keras_import/importer.py``), as the reference's does.
``write_model`` refuses updater state in the ZeRO sharded format
(``parallel/zero.py``), as the reference's does: a zip holds the per-leaf
state, so ``ParallelWrapper.gather_opt_state()`` comes first (or
``save_updater=False``). A network laid out on a model axis (a ``(data,
model)`` ``ParallelWrapper`` left its sharded leaves as per-rank rows,
``parallel/tensor_parallel.py``) is gathered first (``host_gather``, the
reference's ``:59-67``): each rows leaf and its updater state are joined
in rank order, so a zip is layout-free and restores anywhere.
"""
from __future__ import annotations

import json
import zipfile
from typing import Optional

import torch

from ..device import DeviceLike
from ..parallel.data_parallel import flat_opt_state_order, flat_param_order
from ..parallel.tensor_parallel import full, specs_by_id
from ..parallel.zero import is_zero_state

CONFIG_ENTRY = "configuration.json"
PARAMS_ENTRY = "coefficients.bin"
UPDATER_ENTRY = "updaterState.bin"
STATE_ENTRY = "state.bin"
MANIFEST_ENTRY = "manifest.json"

def flat_state_order(net):
    """(group, state name, tensor) for the layer state of ``net`` in
    ``jax.tree.leaves(net.state)``'s order: vertices or layers in order,
    each one's state names sorted (``mean``, ``var``)."""
    return [(group, name, sd[name])
            for group, sd in net.state_dicts().items()
            for name in sorted(sd)]


def _flat_bytes(tensors) -> bytes:
    """The tensors' values, flattened in order, as float32 bytes (one
    copy to the host)."""
    if not tensors:
        return b""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    return flat.cpu().numpy().tobytes()


@torch.no_grad()
def _load_flat(tensors, data: bytes, what: str) -> None:
    """Copy the float32 buffer ``data`` into ``tensors`` in order, each
    cast to its own dtype (one copy to the device)."""
    n = len(data) // 4
    size = sum(t.numel() for t in tensors)
    if n != size or len(data) % 4:
        raise ValueError(f"{what}: flat buffer length {n} != model size "
                         f"{size}")
    if not tensors:
        return
    flat = torch.frombuffer(bytearray(data), dtype=torch.float32).to(
        tensors[0].device)
    off = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[off:off + k].view(t.shape).to(t.dtype))
        off += k


def write_model(net, path: str, save_updater: bool = True,
                extra_manifest: Optional[dict] = None) -> None:
    """Persist a ``MultiLayerNetwork`` or ``ComputationGraph`` to a model
    zip. ``extra_manifest``: JSON-serializable keys merged into the
    manifest (the reference's checkpointing stores its resume position
    there)."""
    _write_zip(net, path, save_updater, extra_manifest, zipfile.ZIP_DEFLATED)


def _write_zip(net, path: str, save_updater: bool,
              extra_manifest: Optional[dict], method: int) -> None:
    """``write_model`` with the zip's ``method``: ``CheckpointListener``
    stores its entries (``ZIP_STORED``) where ``write_model`` deflates
    them; the entries are the same and either package reads both."""
    if save_updater and is_zero_state(net.opt_state):
        # a sharded flat state would be written in the wrong layout
        raise ValueError(
            "net.opt_state is in the ZeRO sharded format; call "
            "ParallelWrapper.gather_opt_state() (or "
            "ZeroUpdateEngine.unshard_opt_state) before writing a model "
            "zip, or pass save_updater=False")
    specs = specs_by_id(net)    # a model axis' rows, joined (host_gather)
    params = [full(p, specs[id(p)]) for _, _, p in flat_param_order(net)]
    states = [t for _, _, t in flat_state_order(net)]
    with zipfile.ZipFile(path, "w", method) as z:
        z.writestr(CONFIG_ENTRY, net.conf.to_json())
        z.writestr(PARAMS_ENTRY, _flat_bytes(params))
        z.writestr(STATE_ENTRY, _flat_bytes(states))
        manifest = {"format": "deeplearning4j_tpu-model", "version": 1,
                    "model_class": type(net).__name__,
                    "n_params": int(sum(p.numel() for p in params)),
                    "n_state": int(sum(t.numel() for t in states)),
                    "iteration_count": getattr(net, "iteration_count", 0),
                    "has_updater": bool(save_updater
                                        and net.opt_state is not None)}
        if manifest["has_updater"]:
            state = [full(t, specs[id(t)])
                     for *_, t in flat_opt_state_order(net)]
            z.writestr(UPDATER_ENTRY, _flat_bytes(state))
            manifest["n_updater_state"] = int(sum(t.numel() for t in state))
        if extra_manifest:
            manifest.update(extra_manifest)
        z.writestr(MANIFEST_ENTRY, json.dumps(manifest))


def _restore(path: str, load_updater: bool, device: DeviceLike, make):
    """Rebuild a network from a zip's configuration, then overwrite its
    parameters, layer state and (with ``load_updater``) updater state from
    the flat buffers."""
    with zipfile.ZipFile(path, "r") as z:
        net = make(z.read(CONFIG_ENTRY).decode(), device)
        manifest = json.loads(z.read(MANIFEST_ENTRY).decode())
        _load_flat([p for _, _, p in flat_param_order(net)],
                   z.read(PARAMS_ENTRY), PARAMS_ENTRY)
        state = z.read(STATE_ENTRY) if STATE_ENTRY in z.namelist() else b""
        if state:        # an empty entry keeps the initial state
            _load_flat([t for _, _, t in flat_state_order(net)], state,
                       STATE_ENTRY)
        if load_updater and manifest.get("has_updater") and \
                UPDATER_ENTRY in z.namelist():
            _load_flat([t for *_, t in flat_opt_state_order(net)],
                       z.read(UPDATER_ENTRY), UPDATER_ENTRY)
        net.iteration_count = manifest.get("iteration_count", 0)
    return net


def _multilayer(text: str, device: DeviceLike):
    from ..nn.conf.config import MultiLayerConfiguration
    from ..nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(text),
                             device=device).init()


def _graph(text: str, device: DeviceLike):
    from ..nn.conf.graph_conf import ComputationGraphConfiguration
    from ..nn.graph.graph import ComputationGraph
    return ComputationGraph(ComputationGraphConfiguration.from_json(text),
                            device=device).init()


def restore_multilayer_network(path: str, load_updater: bool = True, *,
                               device: DeviceLike = None):
    """Rebuild a ``MultiLayerNetwork`` from a model zip (``_restore``)."""
    return _restore(path, load_updater, device, _multilayer)


def restore_computation_graph(path: str, load_updater: bool = True, *,
                              device: DeviceLike = None):
    return _restore(path, load_updater, device, _graph)


def restore_model(path: str, load_updater: bool = True, *,
                  device: DeviceLike = None):
    """Sniff and restore (reference util/ModelGuesser.java): a model zip
    (either model class), a zip saved by the Java reference, a bare
    configuration JSON, which gives a freshly initialized network, or a
    Keras HDF5 file."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            manifest = json.loads(z.read(MANIFEST_ENTRY).decode()) \
                if MANIFEST_ENTRY in names else None
        if manifest is not None:
            if manifest.get("model_class") == "ComputationGraph":
                return restore_computation_graph(path, load_updater,
                                                 device=device)
            return restore_multilayer_network(path, load_updater,
                                              device=device)
        from ..interop.dl4j_zip import import_dl4j_zip, is_dl4j_zip
        if is_dl4j_zip(path):
            # a zip saved by the JAVA reference (ModelSerializer.java:79-96)
            return import_dl4j_zip(path, load_updater=load_updater,
                                   device=device)
        raise ValueError(f"{path}: zip but not a deeplearning4j_tpu model")
    with open(path, "rb") as f:
        raw = f.read()
    try:
        text = raw.decode()
        data = json.loads(text)
    except (json.JSONDecodeError, UnicodeDecodeError):
        pass
    else:
        body = data.get("config", data) if isinstance(data, dict) else data
        if isinstance(body, dict) and \
                body.get("@class") == "ComputationGraphConfiguration":
            return _graph(text, device)
        return _multilayer(text, device)
    try:
        from ..keras_import.importer import import_keras_model
        return import_keras_model(path, device=device)
    except Exception as e:
        raise ValueError(f"Cannot determine model type of {path}") from e
