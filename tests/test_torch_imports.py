"""The port stands alone: importing any module of deeplearning4j_tpu_torch
pulls in neither jax nor the JAX package, and neither the package's source
nor the scripts that drive it on the card (chip_smoke.py, k7_study.py,
lstm_study.py, gen_study.py) name them in an import."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "deeplearning4j_tpu" or m.startswith("deeplearning4j_tpu."))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""

# every slice's modules, so a module that stops being importable (or is
# moved out of the walk) is noticed
_REQUIRED = {f"deeplearning4j_tpu_torch.{m}" for m in (
    "ops.flash_attention", "ops.lstm", "ops.nvcc", "nn.multilayer",
    "nn.layers.recurrent", "nn.conf.config", "optimize.solver",
    "models.decode", "models.zoo_extra", "interop.jax_params",
    "serving.generation.programs", "serving.generation.scheduler",
    "ops.kernels.conv", "ops.kernels.quantized", "nn.layers.conv",
    "models.zoo", "serving.engine", "serving.batcher", "serving.programs",
    "ops.compression", "ops.threshold_encode", "parallel.mesh",
    "parallel.accumulation", "parallel.data_parallel",
    "parallel.ring_attention", "serving.generation.kvcache",
    "serving.generation.prefix", "serving.generation.speculative",
    "serving.generation.metrics", "serving.generation.engine",
    "serving.generation.graphs", "serving.generation.sampling",
    "util.retry", "util.httpjson", "util.serialization",
    "util.checkpointing", "nn.conf.serde", "nn.preprocessors",
    "nn.inputs", "serving.registry", "serving.http",
    "optimize.step_graph", "optimize.updaters", "datasets.dataset",
    "datasets.prefetch", "datasets.iterators", "util.graph_capture",
    "nn.tape", "nn.layers.norm", "nn.layers.core", "nn.graph.vertices",
    "nn.transfer", "models.lenet", "eval", "eval.evaluation", "eval.binary",
    "eval.roc", "eval.regression", "eval.meta", "eval.tools",
    "earlystopping", "earlystopping.early_stopping",
    "earlystopping.parallel_trainer", "nn.layers.variational",
    "optimize.second_order", "util.gradcheck", "util.timeseries",
    "graft_entry", "optimize.listeners", "parallel.overlap", "parallel.zero",
    "util.distributed_checkpoint", "util.async_checkpoint",
    "parallel.tensor_parallel", "parallel.resharding", "parallel.pipeline",
    "parallel.expert_parallel", "serving.buckets", "nn.layers.attention",
    "parallel.elastic", "parallel.faults", "parallel.distributed",
    "parallel.inference", "parallel.model_server", "parallel.streaming",
    "telemetry", "telemetry.registry", "telemetry.tracecontext",
    "telemetry.spans", "telemetry.spool", "telemetry.flightrec",
    "telemetry.torchsignals", "telemetry.memprof", "telemetry.perf",
    "telemetry.slo", "serving.fleet", "serving.fleet.affinity",
    "serving.fleet.coldstart", "serving.fleet.replica",
    "serving.fleet.router", "serving.fleet.collector",
    "serving.fleet.autoscale", "serving.fleet.http")}

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|deeplearning4j_tpu)\b(?!_torch)"
    r"|from\s+(jax|deeplearning4j_tpu)\b(?!_torch))"
    r"|\bdeeplearning4j_tpu\.(?!_)", re.M)


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    n_modules, bad = int(lines[0]), lines[1]
    assert n_modules >= 20
    assert bad == "", f"importing the port loaded {bad}"
    assert _REQUIRED <= set(lines[2].split(","))


def test_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "k7_study.py",
                                         ROOT / "lstm_study.py",
                                         ROOT / "gen_study.py"]
    assert len(files) > 20
    assert PKG / "serving" / "generation" / "graphs.py" in files
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import nn",
                 "from deeplearning4j_tpu.nn import layers",
                 "import deeplearning4j_tpu",
                 "x = deeplearning4j_tpu.models"):
        assert _FORBIDDEN.search(line), line
    for line in ("from deeplearning4j_tpu_torch.ops import flash_attention",
                 "import deeplearning4j_tpu_torch",
                 "see ``deeplearning4j_tpu/ops/pallas_attention.py``",
                 "import jaxlib_free_module"):
        assert not _FORBIDDEN.search(line), line
