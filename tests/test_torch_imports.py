"""The port stands alone: importing any module of deeplearning4j_tpu_torch
pulls in neither jax, the JAX package, keras nor h5py, and neither the
package's source nor the scripts that drive it on the card (chip_smoke.py,
k7_study.py, lstm_study.py, gen_study.py) name jax, keras or the JAX
package in an import; h5py is imported only inside the Keras importer's
functions that open an ``.h5`` file. A module that the package itself
imports late (``util.distributed_checkpoint`` and its neighbours) imports
first in a fresh interpreter too."""
import _torch_threads  # noqa: F401
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "deeplearning4j_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "deeplearning4j_tpu", "keras",
                                    "h5py"))
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
    "serving.fleet.autoscale", "serving.fleet.http", "ops.kernels",
    "ops.kernels.registry", "ops.kernels.builtins", "ops.kernels.autotune",
    "ui", "ui.storage", "ui.components", "ui.i18n", "ui.stats",
    "ui.visual", "ui.dashboard", "nlp", "nlp.tokenizer",
    "nlp.sentence_iterator", "nlp.vocab", "nlp.dict_build", "nlp.serde",
    "nlp.vectorizers", "nlp.sequence_vectors", "nlp.word2vec", "nlp.glove",
    "nlp.distributed_w2v", "nlp.segmentation", "nlp.lemmatizer",
    "nlp.pos", "graphs", "graphs.graph", "graphs.deepwalk",
    "graphs.node2vec", "clustering", "clustering.kmeans",
    "clustering.vptree", "clustering.trees", "clustering.tsne",
    "clustering.server", "ml", "datasets.export", "datasets.fetchers",
    "datasets.mnist", "models.pretrained", "native", "interop",
    "interop.dl4j_zip", "keras_import", "keras_import.importer")}

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|keras|deeplearning4j_tpu)\b(?!_torch)"
    r"|from\s+(jax|keras|deeplearning4j_tpu)\b(?!_torch))"
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


def test_h5py_is_imported_only_where_a_file_is_opened():
    """In the package only the Keras importer names h5py; there and in
    chip_smoke.py (which looks for it on the card's machine) only inside
    a function."""
    hits = [(f.relative_to(ROOT).as_posix(), m.group(1))
            for f in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            for m in re.finditer(r"^([ \t]*)(import|from)\s+h5py\b",
                                 f.read_text(), re.M)]
    assert {f for f, _ in hits} == {
        "deeplearning4j_tpu_torch/keras_import/importer.py", "chip_smoke.py"}
    assert all(indent for _, indent in hits), hits


@pytest.mark.parametrize("module", ["util.distributed_checkpoint",
                                    "util.async_checkpoint",
                                    "parallel.faults"])
def test_module_imports_first_in_a_fresh_interpreter(module):
    """The import cycle between the sharded checkpoints and the parallel
    package stays broken: each side imports first on its own."""
    out = subprocess.run(
        [sys.executable, "-c", f"import deeplearning4j_tpu_torch.{module}"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import nn",
                 "import keras", "from keras import layers",
                 "from deeplearning4j_tpu.nn import layers",
                 "import deeplearning4j_tpu",
                 "x = deeplearning4j_tpu.models"):
        assert _FORBIDDEN.search(line), line
    for line in ("from deeplearning4j_tpu_torch.ops import flash_attention",
                 "import deeplearning4j_tpu_torch",
                 "see ``deeplearning4j_tpu/ops/pallas_attention.py``",
                 "import jaxlib_free_module"):
        assert not _FORBIDDEN.search(line), line
