"""Configuration serialization: every configuration object to JSON and back.

Counterpart of ``deeplearning4j_tpu/nn/conf/serde.py``. Encoding tags each
object with ``"@class"``, its class name, and writes its fields in order;
decoding looks the class up in a registry and calls it with the fields it
knows (unknown keys are dropped, as the reference drops them). The class
names and field names are the reference's letter for letter, so a file
written by either package is read by the other.

A dataclass (the updaters, schedules, distributions, input types,
preprocessors and the two network configurations) is serialized through
``dataclasses.fields``. A layer or vertex is an ``nn.Module`` here, which
``dataclasses`` does not see: its class lists its fields in
``serde_fields``, in the reference dataclass's order, and only those
attribute values are written, never parameters or buffers.

A class that the reference registers and the port lacks raises
``NotImplementedError`` naming its ROADMAP item (``NOT_PORTED``).
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import json
from typing import Any, Dict, Tuple, Type

_REGISTRY: Dict[str, Type] = {}

# v2: SubsamplingLayer gained avg_pool_include_pad_in_divisor; a v1 payload
# without it reads with the default, True (the reference's contract)
CONFIG_FORMAT_VERSION = 2

# the reference's registered classes that have no port yet, by ROADMAP
# item (none since A5's second half)
NOT_PORTED: Dict[str, str] = {}

# the modules whose classes register themselves on import
_MODULES = ("deeplearning4j_tpu_torch.nn.inputs",
            "deeplearning4j_tpu_torch.nn.preprocessors",
            "deeplearning4j_tpu_torch.nn.weights",
            "deeplearning4j_tpu_torch.optimize.updaters",
            "deeplearning4j_tpu_torch.nn.layers",
            "deeplearning4j_tpu_torch.nn.graph.vertices",
            "deeplearning4j_tpu_torch.nn.conf.config",
            "deeplearning4j_tpu_torch.nn.conf.graph_conf")


def register(cls):
    """Class decorator: make a configuration class JSON round-trippable."""
    _REGISTRY[cls.__name__] = cls
    return cls


register_enum = register


def _load_all() -> None:
    for m in _MODULES:
        importlib.import_module(m)


def lookup(name: str):
    if name not in _REGISTRY:
        _load_all()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP {NOT_PORTED[name]})")
    raise ValueError(f"Unknown config class {name!r}; registered: "
                     f"{sorted(_REGISTRY)}")


def field_names(cls) -> Tuple[str, ...]:
    """The serialized fields of a registered class, in order."""
    if dataclasses.is_dataclass(cls):
        return tuple(f.name for f in dataclasses.fields(cls)
                     if not f.metadata.get("skip_serde", False))
    return tuple(cls.serde_fields)


def to_dict(obj: Any) -> Any:
    """Recursively encode a configuration object tree to plain JSON data."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return {"@enum": type(obj).__name__, "value": obj.name}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): to_dict(v) for k, v in obj.items()}
    cls = type(obj)
    if _REGISTRY.get(cls.__name__) is cls:
        d = {"@class": cls.__name__}
        for name in field_names(cls):
            d[name] = to_dict(getattr(obj, name))
        return d
    raise TypeError(f"Cannot serialize {cls!r}: {obj!r}")


def from_dict(data: Any) -> Any:
    """Inverse of :func:`to_dict`."""
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    if isinstance(data, dict):
        if "@enum" in data:
            return lookup(data["@enum"])[data["value"]]
        if "@class" in data:
            cls = lookup(data["@class"])
            raw = {k: from_dict(v) for k, v in data.items() if k != "@class"}
            if hasattr(cls, "_migrate"):
                raw = cls._migrate(raw)
            known = set(field_names(cls))
            return cls(**{k: v for k, v in raw.items() if k in known})
        return {k: from_dict(v) for k, v in data.items()}
    raise TypeError(f"Cannot deserialize {data!r}")


def to_json(obj: Any, indent: int = 2) -> str:
    return json.dumps({"format_version": CONFIG_FORMAT_VERSION,
                       "config": to_dict(obj)}, indent=indent)


def from_json(s: str) -> Any:
    data = json.loads(s)
    if isinstance(data, dict) and "format_version" in data:
        data = data["config"]
    return from_dict(data)
