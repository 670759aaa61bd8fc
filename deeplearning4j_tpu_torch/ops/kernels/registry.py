"""Kernel registry: name -> hand-written kernel + plain version + metadata.

Counterpart of ``deeplearning4j_tpu/ops/kernels/registry.py``: ``ParityPin``
and ``KernelSpec`` (``:30-75``), ``register`` with duplicates rejected,
``get``, ``names``, ``active_impl``, ``kernels_snapshot`` and
``record_kernel_timing`` (``:78-189``). Each registered ``KernelSpec``
carries the kernel's wrapper (the hand-written CUDA kernel on a CUDA
tensor, the plain version on a CPU one), the plain version, the probe, a
parity pin (``tests/test_torch_kernel_registry.py`` runs one parity test
for each registered kernel, so registering one without a pin fails) and
the roofline model the ``perf.kernels.<name>.*`` gauges use to flag a
kernel running below its bound.

Deliberate differences:

- No kill switch and no interpret mode: ``envutil.py`` is not ported, so
  a spec has no ``kill_aliases``, ``interpret_aliases``, ``enabled()``,
  ``interpret_opted_in()`` or ``available()``. The device picks the
  implementation: :func:`active_impl` is ``"fused"`` on a CUDA device (the
  hand-written kernel, built at its first launch; a failed build raises)
  and ``"fallback"`` on the CPU (the plain version). With no device given
  it resolves the device as every entry point does and raises when there
  is no card.
- A pin's ``run(seed, device)`` computes both outputs on ``device``.
- A spec carries ``dtype``, the type its roofline counts operations in:
  the port's peaks are by dtype (``telemetry/perf.py`` ``CHIP_PEAKS``), and
  an f32 kernel held against the bf16 peak would read 15x too slow.
- A snapshot row names the device it describes (``"device"``) and leaves
  out the reference's ``kill_env``, ``kill_aliases`` and ``interpret_env``;
  ``enabled`` is always true.

The builtin kernels register lazily (``_ensure_builtins``) so importing the
registry builds and imports no kernel module.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ...device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParityPin:
    """How to check a kernel against its plain version.

    ``run(seed, device)`` draws the pin's inputs from
    ``np.random.default_rng(seed)`` in the reference pin's order, puts
    them on ``device`` and returns ``(kernel outputs, plain outputs)``,
    each a flat list of tensors (on the CPU both come from the plain
    version). ``tol`` is the largest absolute error allowed; 0.0 means
    bitwise.
    """
    run: Callable[[int, Any], Tuple[List[Any], List[Any]]]
    tol: float = 0.0
    note: str = ""


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel. ``fused`` is the wrapper (kernel on CUDA
    tensors, plain version on CPU ones), ``fallback`` the plain version;
    their signatures are the kernel's own (callers go through the module
    entry points: the registry is the metadata, parity and tuning spine).
    ``applicable`` is the probe. ``roofline(shape_sig) -> (operations,
    bytes)`` of one call, operations counted in ``dtype``."""
    name: str
    fused: Callable
    fallback: Callable
    applicable: Callable[..., bool]
    parity: Optional[ParityPin] = None
    roofline: Optional[Callable[[str], Tuple[float, float]]] = None
    dtype: str = "float32"
    tunable: str = ""                 # what decides the kernel's tiling
    default_choice: Optional[Tuple[int, ...]] = None
    notes: str = ""


_LOCK = threading.Lock()
_REGISTRY: Dict[str, KernelSpec] = {}
_BUILTINS_LOADED = False


def register(spec: KernelSpec) -> KernelSpec:
    with _LOCK:
        if spec.name in _REGISTRY:
            raise ValueError(f"kernel {spec.name!r} already registered")
        _REGISTRY[spec.name] = spec
    return spec


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    with _LOCK:
        if _BUILTINS_LOADED:
            return
        _BUILTINS_LOADED = True
    from . import builtins as _builtins  # noqa: F401 — registers on import


def get(name: str) -> KernelSpec:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r} registered "
                       f"(have: {sorted(_REGISTRY)})") from None


def names() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def active_impl(name: str, device: DeviceLike = None) -> str:
    """Which implementation a call on ``device`` runs: 'fused' (the
    hand-written kernel) on a CUDA device, 'fallback' (the plain version)
    on the CPU. ``None`` is the current card, and raises without one."""
    get(name)
    return "fused" if resolve_device(device).type == "cuda" else "fallback"


def kernels_snapshot() -> Dict[str, Dict[str, Any]]:
    """One JSON-able dict per registered kernel, for the process's card
    when it has one and the CPU otherwise: embedded in
    ``telemetry.perf.perf_snapshot()['kernels']`` (so perf dumps carry it)
    and read back by ``tools/kernels_report.py`` and the dashboard card."""
    from . import autotune
    device = resolve_device(None if torch.cuda.is_available() else "cpu")
    out: Dict[str, Dict[str, Any]] = {}
    for name in names():
        spec = get(name)
        row: Dict[str, Any] = {
            "impl": active_impl(name, device),
            "enabled": True,
            "device": str(device),
            "tunable": spec.tunable,
            "has_parity_pin": spec.parity is not None,
        }
        if spec.default_choice is not None:
            row["default_choice"] = list(spec.default_choice)
        decisions = autotune.decisions_for(name)
        if decisions:
            row["autotune"] = decisions
        out[name] = row
    return out


def record_kernel_timing(name: str, shape_sig: str,
                         measured_s: float) -> Optional[Dict[str, float]]:
    """Fold one measured kernel time into the live perf gauges and flag a
    kernel below its roofline: ``perf.kernels.<name>.measured_ms`` /
    ``.roofline_ms`` / ``.vs_roofline`` / ``.below_roofline`` (1.0 when the
    kernel takes more than 2x its bound). The bound is the roofline model's
    operations and bytes against the peak of the spec's dtype on the
    current card. Returns None, and sets nothing, where the kernel has no
    roofline model, the signature does not parse, the time is not
    positive or there is no peak (the CPU)."""
    spec = get(name)
    if spec.roofline is None or measured_s <= 0:
        return None
    try:
        flops, nbytes = spec.roofline(shape_sig)
    except (TypeError, ValueError):
        return None
    from ...telemetry import get_registry
    from ...telemetry.perf import classify_roofline
    cls = classify_roofline(flops, nbytes, dtype=spec.dtype)
    if cls.get("attainable_tflops") is None:
        return None
    # attainable_tflops already folds in memory-bound derating
    att = max(cls["attainable_tflops"], 1e-9)
    roof_s = (flops / 1e12) / att if flops else 0.0
    ratio = (measured_s / roof_s) if roof_s else 0.0
    row = {"measured_ms": measured_s * 1e3, "roofline_ms": roof_s * 1e3,
           "vs_roofline": ratio,
           "below_roofline": 1.0 if (ratio and ratio > 2.0) else 0.0}
    reg = get_registry()
    if reg.enabled:
        base = f"perf.kernels.{name}"
        for k, v in row.items():
            reg.gauge(f"{base}.{k}").set(v)
    return row
