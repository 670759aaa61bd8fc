"""The kernel registry, its builtin pins and the autotune cache
(``ops/kernels/{registry,builtins,autotune}.py``) against the JAX
package's ``ops/kernels``.

- Every registered kernel carries a parity pin: the parity test below runs
  once a registered name, so a kernel registered without a pin fails it.
- On the CPU a pin's kernel outputs are the wrapper's, which computes the
  plain version there; its plain outputs are held against the JAX
  package's fallback (``xla_attention``, ``_lstm_scan_ref``,
  ``_encode_xla``, ``int8_matmul_xla``, ``_conv1x1_xla``) on the same
  seed's inputs, at the reference pin's tolerance (2e-5, 1e-5, bitwise,
  bitwise, 1e-5).
- Each roofline is the reference's formula for the same shape signature,
  and ``record_kernel_timing`` sets the reference's gauges for the same
  signature, time and peaks (pinned through ``BENCH_PEAK_TFLOPS`` /
  ``BENCH_HBM_GBPS``). With no peak (the CPU) it sets nothing.
- Autotune decisions are measured once, cached per (kernel, shape-sig,
  backend) and replayed; without a measurement "defaults stand" is
  recorded with its reason; a record the JAX package wrote is never
  replayed by the port.
- ``tools/kernels_report.py``, unchanged, reads a perf dump the port
  wrote.
"""
import _torch_threads  # noqa: F401
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_flightrec import _port_flightrec_dir  # noqa: F401

import jax.numpy as jnp
from deeplearning4j_tpu import telemetry as jtel
from deeplearning4j_tpu.ops import kernels as jkernels
from deeplearning4j_tpu.ops.kernels import autotune as jautotune
from deeplearning4j_tpu.ops.kernels import builtins as jbuiltins
from deeplearning4j_tpu.ops.kernels import conv as jconv
from deeplearning4j_tpu.ops.kernels import quantized as jq
from deeplearning4j_tpu.parallel.ring_attention import attention as jattn
from deeplearning4j_tpu_torch import telemetry as ptel
from deeplearning4j_tpu_torch.ops import kernels
from deeplearning4j_tpu_torch.ops.kernels import autotune, registry

BUILTINS = ("attention", "conv1x1_bias_relu", "int8_matmul", "lstm",
            "threshold_encode")
TOLS = {"attention": 2e-5, "lstm": 1e-5, "threshold_encode": 0.0,
        "int8_matmul": 0.0, "conv1x1_bias_relu": 1e-5}
# one shape signature a kernel, in the reference's format
SIGS = {"attention": "1x16x1024x64", "lstm": "64x32x512",
        "threshold_encode": "42533888", "int8_matmul": "256x512x512",
        "conv1x1_bias_relu": "25088x480x192"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) if a.size else 0.0


# ----------------------------------------------------------------- registry
def test_builtin_kernels_registered():
    assert tuple(kernels.names()) == BUILTINS == tuple(jkernels.names())


def test_duplicate_registration_rejected():
    with pytest.raises(ValueError, match="already registered"):
        kernels.register(kernels.get("attention"))
    with pytest.raises(KeyError, match="no kernel 'nope'"):
        kernels.get("nope")


def _check_pinned(name):
    spec = kernels.get(name)
    assert spec.parity is not None, \
        f"kernel {name!r} registered without a parity pin"
    assert spec.parity.tol == TOLS.get(name, spec.parity.tol)


@pytest.mark.parametrize("name", kernels.names())
def test_every_kernel_has_parity_pin(name):
    _check_pinned(name)


def test_registering_without_a_pin_fails_the_pin_check(monkeypatch):
    spec = kernels.get("attention")
    bare = registry.KernelSpec(name="unpinned", fused=spec.fused,
                               fallback=spec.fallback,
                               applicable=spec.applicable)
    monkeypatch.setitem(registry._REGISTRY, "unpinned", bare)
    assert "unpinned" in kernels.names()
    with pytest.raises(AssertionError, match="without a parity pin"):
        _check_pinned("unpinned")


@pytest.mark.parametrize("name", kernels.names())
def test_kernel_parity_on_the_cpu(name):
    """The pin's two sides on the CPU, where the wrapper computes the
    plain version: within the declared tolerance."""
    spec = kernels.get(name)
    fused, plain = spec.parity.run(0, "cpu")
    assert len(fused) == len(plain) and fused
    for a, b in zip(fused, plain):
        assert a.device.type == "cpu"
        assert _err(a, b) <= spec.parity.tol, (name, spec.parity.note)


# ------------------------------------------ the pins against the reference
def _jax_fallback(name, seed):
    """The JAX package's fallback on the reference pin's inputs."""
    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    if name == "attention":
        q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 256, 64)) * 0.3,
                               f32) for _ in range(3))
        return [jattn(q, k, v, causal=True)]
    if name == "lstm":
        T, B, H = 4, 8, 128
        xp = jnp.asarray(rng.standard_normal((T, B, 4 * H)) * 0.3, f32)
        h0 = jnp.asarray(rng.standard_normal((B, H)) * 0.1, f32)
        c0 = jnp.asarray(rng.standard_normal((B, H)) * 0.1, f32)
        Rm = jnp.asarray(rng.standard_normal((H, 4 * H)) * 0.1, f32)
        hs, (hT, cT) = jbuiltins._lstm_scan_ref(xp, h0, c0, Rm)
        return [hs, hT, cT]
    if name == "threshold_encode":
        r = jnp.asarray(rng.standard_normal(((1 << 16) + 777,)) * 1e-3, f32)
        return list(jbuiltins._encode_xla(r, 1e-3))
    if name == "int8_matmul":
        x = jnp.asarray(rng.standard_normal((64, 256)), f32)
        w = jnp.asarray(rng.standard_normal((256, 256)), f32)
        w_q, w_s = jq.quantize_weights(w)
        x_q, x_s = jq.quantize_rows(x)
        return [jq.int8_matmul_xla(x_q, w_q, x_s, w_s)]
    assert name == "conv1x1_bias_relu"
    N, H, Wd, C, F = 2, 4, 4, 128, 128
    x = jnp.asarray(rng.standard_normal((N, H, Wd, C)), f32)
    W = jnp.asarray(rng.standard_normal((1, 1, C, F)) * 0.1, f32)
    b = jnp.asarray(rng.standard_normal((F,)) * 0.1, f32)
    return [jconv._conv1x1_xla(x.reshape(-1, C), W.reshape(C, F),
                               b).reshape(N, H, Wd, F)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", BUILTINS)
def test_pin_plain_equals_the_reference_fallback(name, seed):
    _, plain = kernels.get(name).parity.run(seed, "cpu")
    want = _jax_fallback(name, seed)
    assert len(plain) == len(want)
    for a, b in zip(plain, want):
        assert _err(a, b) <= TOLS[name], name


@pytest.mark.parametrize("name", BUILTINS)
def test_roofline_is_the_references(name):
    got = kernels.get(name).roofline(SIGS[name])
    want = jkernels.get(name).roofline(SIGS[name])
    assert got == want and got[0] > 0 and got[1] > 0
    assert kernels.get(name).dtype == ("int8" if name == "int8_matmul"
                                       else "float32")


def test_defaults_describe_the_ports_tiling():
    assert kernels.get("attention").default_choice == (64, 64)
    assert jkernels.get("attention").default_choice == (512, 1024)
    assert kernels.get("conv1x1_bias_relu").default_choice == (64, 32)
    assert kernels.get("int8_matmul").default_choice == (16, 32)
    assert kernels.get("lstm").default_choice == (2, 8)


# ------------------------------------------------------------ active_impl
@pytest.mark.parametrize("name", BUILTINS)
def test_active_impl_by_device(name, monkeypatch):
    assert kernels.active_impl(name, device="cpu") == "fallback"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.active_impl(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert kernels.active_impl(name, device="cuda:0") == "fused"


# ---------------------------------------------------------------- autotune
@pytest.fixture
def tuned_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("DL4J_TPU_AUTOTUNE_CACHE", path)
    return path


def test_autotune_backend_is_the_ports(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune._backend() == "torch-cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert autotune._backend() == "cuda:NVIDIA H100 80GB HBM3"
    monkeypatch.delenv("DL4J_TPU_AUTOTUNE_CACHE", raising=False)
    assert autotune.cache_path().endswith(
        os.path.join(".cache", "deeplearning4j_tpu_torch", "autotune.json"))


def test_autotune_measures_and_changes_default(tuned_cache):
    times = {(64, 64): 3.0e-3, (64, 32): 1.0e-3, (128, 32): 2.0e-3}
    calls = []

    def measure(cand):
        calls.append(cand)
        return times[tuple(cand)]

    rec = autotune.decide("conv1x1_bias_relu", "M9999", list(times),
                          measure, default=(64, 64))
    assert rec["choice"] == [64, 32]
    assert rec["changed_default"] is True
    assert "argmin" in rec["why"]
    assert len(calls) == 3
    with open(tuned_cache) as f:
        data = json.load(f)
    assert data["autotune_cache"] == 1
    key = autotune.AutotuneCache.key("conv1x1_bias_relu", "M9999",
                                     autotune._backend())
    assert data["decisions"][key]["choice"] == [64, 32]


def test_autotune_replays_without_remeasuring(tuned_cache):
    autotune.decide("int8_matmul", "T777", [(16, 32)], lambda c: 1.0e-3,
                    default=(16, 32))

    def boom(cand):
        raise AssertionError("replay must not re-measure")

    rec = autotune.decide("int8_matmul", "T777", [(16, 32)], boom,
                          default=(16, 32))
    assert rec["choice"] == [16, 32] and rec["replays"] == 1
    assert autotune.cached_decision("int8_matmul", "T777") == [16, 32]
    with open(tuned_cache) as f:
        data = json.load(f)
    key = autotune.AutotuneCache.key("int8_matmul", "T777",
                                     autotune._backend())
    assert data["decisions"][key]["replays"] == 2


def test_autotune_defaults_stand_without_measurement(tuned_cache):
    rec = autotune.decide("attention", "T555", [(64, 64), (128, 64)], None,
                          default=(64, 64))
    assert rec["choice"] == [64, 64]
    assert rec["changed_default"] is False
    assert "defaults stand" in rec["why"] and "torch-cpu" in rec["why"]
    assert autotune.decisions_for("attention")


def test_autotune_corrupt_cache_is_empty(tuned_cache):
    with open(tuned_cache, "w") as f:
        f.write("{not json")
    assert autotune.cached_decision("attention", "T1024") is None
    rec = autotune.decide("attention", "T1024", [(64, 64)], None,
                          default=(64, 64))
    assert rec["choice"] == [64, 64]


def test_a_reference_decision_is_never_replayed(tuned_cache):
    """A record the JAX package wrote into the shared file (backend "cpu")
    neither replays in the port nor shows on its snapshot rows."""
    jautotune.decide("attention", "T2048", [(256, 512)], lambda c: 1e-3,
                     default=(512, 1024))
    assert jautotune.cached_decision("attention", "T2048") == [256, 512]
    assert autotune.cached_decision("attention", "T2048") is None
    assert autotune.decisions_for("attention") == {}
    calls = []
    rec = autotune.decide("attention", "T2048", [(64, 64)],
                          lambda c: calls.append(c) or 2e-3,
                          default=(64, 64))
    assert calls == [(64, 64)] and rec["replays"] == 0
    with open(tuned_cache) as f:
        keys = sorted(json.load(f)["decisions"])
    assert keys == ["attention|T2048|cpu", "attention|T2048|torch-cpu"]


# ------------------------------------------------- snapshot + perf gauges
def test_kernels_snapshot_rows(tuned_cache):
    snap = kernels.kernels_snapshot()
    assert sorted(snap) == list(BUILTINS)
    for name in BUILTINS:
        row = snap[name]
        assert row["impl"] == "fallback" and row["device"] == "cpu"
        assert row["enabled"] is True and row["has_parity_pin"] is True
        assert row["tunable"]
        assert not {"kill_env", "kill_aliases", "interpret_env"} & set(row)
        assert "autotune" not in row
    assert snap["attention"]["default_choice"] == [64, 64]
    autotune.decide("int8_matmul", "64x256x256", [(16, 32)], None,
                    default=(16, 32))
    assert kernels.kernels_snapshot()["int8_matmul"]["autotune"]


def test_perf_snapshot_carries_kernels():
    from deeplearning4j_tpu_torch.telemetry.perf import perf_snapshot
    out = perf_snapshot()
    assert set(out["kernels"]) == set(BUILTINS)


@pytest.fixture
def pinned_peaks(monkeypatch):
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "67")
    monkeypatch.setenv("BENCH_HBM_GBPS", "3350")


@pytest.mark.parametrize("measured_s", [2e-4, 10.0])
@pytest.mark.parametrize("name", BUILTINS)
def test_record_kernel_timing_gauges_equal_the_references(
        name, measured_s, pinned_peaks):
    jreg, preg = jtel.MetricsRegistry(enabled=True), \
        ptel.MetricsRegistry(enabled=True)
    jprev, pprev = jtel.set_registry(jreg), ptel.set_registry(preg)
    try:
        want = jkernels.record_kernel_timing(name, SIGS[name], measured_s)
        got = kernels.record_kernel_timing(name, SIGS[name], measured_s)
    finally:
        jtel.set_registry(jprev)
        ptel.set_registry(pprev)
    assert got == want and got is not None
    base = f"perf.kernels.{name}"
    for key in ("measured_ms", "roofline_ms", "vs_roofline",
                "below_roofline"):
        assert preg.gauge(f"{base}.{key}").value == \
            jreg.gauge(f"{base}.{key}").value == got[key]
    assert got["below_roofline"] == (1.0 if got["vs_roofline"] > 2 else 0.0)


def test_record_kernel_timing_declines(pinned_peaks):
    assert kernels.record_kernel_timing("int8_matmul", "bogus", 1.0) is None
    assert kernels.record_kernel_timing("lstm", "4x8x128", 0.0) is None


def test_record_kernel_timing_sets_nothing_without_a_peak(monkeypatch):
    """On the CPU there is no peak: no gauge, None (the reference's
    no-roofline case)."""
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_HBM_GBPS", raising=False)
    reg = ptel.MetricsRegistry(enabled=True)
    prev = ptel.set_registry(reg)
    try:
        assert kernels.record_kernel_timing("lstm", "64x32x512", 1e-3) \
            is None
    finally:
        ptel.set_registry(prev)
    assert reg.gauge_if_exists("perf.kernels.lstm.measured_ms") is None


def test_dtype_picks_the_peak(monkeypatch):
    """An f32 kernel is held against the card's f32 peak, int8 against
    int8's: with the H100 table (no env pins) the bounds differ by the
    peaks' ratio for a compute-bound signature."""
    from deeplearning4j_tpu_torch.telemetry import perf
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("BENCH_HBM_GBPS", raising=False)
    monkeypatch.setattr(perf, "chip_peaks",
                        lambda device=None: perf.CHIP_PEAKS[
                            "NVIDIA H100 80GB HBM3"])
    reg = ptel.MetricsRegistry(enabled=True)
    prev = ptel.set_registry(reg)
    try:
        f32 = kernels.record_kernel_timing("conv1x1_bias_relu",
                                           "25088x480x192", 1e-3)
        i8 = kernels.record_kernel_timing("int8_matmul", "4096x4096x4096",
                                          1e-3)
    finally:
        ptel.set_registry(prev)
    flops, _ = kernels.get("conv1x1_bias_relu").roofline("25088x480x192")
    assert f32["roofline_ms"] == pytest.approx(flops / 67e12 * 1e3,
                                               rel=1e-3)
    flops, _ = kernels.get("int8_matmul").roofline("4096x4096x4096")
    assert i8["roofline_ms"] == pytest.approx(flops / 1979e12 * 1e3,
                                              rel=1e-3)


# -------------------------------------------------------------- the report
def test_kernels_report_reads_the_ports_dump(tmp_path, pinned_peaks):
    reg = ptel.MetricsRegistry(enabled=True)
    prev = ptel.set_registry(reg)
    try:
        kernels.record_kernel_timing("threshold_encode", "42533888", 1.5e-4)
        dump = ptel.write_perf_dump(str(tmp_path / "perf.json"),
                                    registry=reg)
    finally:
        ptel.set_registry(prev)
    env = dict(os.environ,
               DL4J_TPU_AUTOTUNE_CACHE=str(tmp_path / "none.json"))
    out = subprocess.run([sys.executable, "tools/kernels_report.py", dump],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    rows = [ln for ln in out.stdout.splitlines()
            if ln.split()[:1] and ln.split()[0] in BUILTINS]
    assert [r.split()[0] for r in rows[:5]] == list(BUILTINS)
    assert all(r.split()[1] == "fallback" for r in rows[:5])
    assert any(ln.strip().startswith("threshold_encode") and "roofline" in ln
               for ln in out.stdout.splitlines())
    js = subprocess.run([sys.executable, "tools/kernels_report.py", dump,
                         "--json"], cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=60)
    report = json.loads(js.stdout)
    assert [r["kernel"] for r in report["roofline"]] == ["threshold_encode"]
    assert set(report["kernels"]) == set(BUILTINS)
