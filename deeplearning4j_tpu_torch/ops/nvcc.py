"""Building the port's CUDA sources: ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface, loaded with ``ctypes``.

The JAX package has no counterpart: its Pallas kernels compile inside XLA.
Each source under ``csrc/`` becomes one library under ``ops/_build/``
(git-ignored), named by the hash of the source and the local headers it
includes (``#include "..."``, directly or through another local header),
so an edited source or header rebuilds;
nvcc's report (registers, shared memory, spills), preceded by the build's
seconds, is kept beside it with the suffix ``.log``. Sources are built at
first use, never at import. ``BUILD_DIR`` is the directory a serving
fleet's replicas share (``serving/fleet/coldstart.py`` points it
elsewhere); ``build_counts()`` says how many libraries this process built
and how many it found built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Sequence

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "ops" / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_symbols: Dict[str, object] = {}     # C entry points, loaded once
_counts = {"built": 0, "found": 0}    # build_library's answers, this process


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the port's CUDA kernels "
                           "cannot be built")
    return found


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (``cuobjdump``, ...) from the directory of the
    nvcc that builds the kernels."""
    found = Path(_nvcc()).resolve().parent / name
    if not found.exists():
        raise RuntimeError(f"{name} not found beside nvcc ({found.parent})")
    return str(found)


def _local_headers(source: Path):
    """The local headers ``source`` includes, directly or through another
    local header, each once, in the order first met."""
    found, todo = [], [source]
    while todo:
        text = todo.pop(0).read_text()
        for h in re.findall(r'^#include "([^"]+)"', text, flags=re.M):
            path = source.parent / h
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in _local_headers(source):
        h.update(header.read_bytes())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build_library(source: Path) -> Path:
    """Compile ``source`` unless its library exists; return the library."""
    out = library_path(source)
    if out.exists():
        _counts["found"] += 1
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(
        f"# nvcc {seconds:.1f} s\n" + " ".join(cmd) + "\n" + res.stdout
        + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                           f"{source.name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    _counts["built"] += 1
    return out


def build_counts() -> Dict[str, int]:
    """This process's ``build_library`` calls: ``built``, the libraries
    nvcc compiled; ``found``, those already in ``BUILD_DIR``."""
    return dict(_counts)


def load_symbol(symbol: str, build: Callable[[], Path],
                argtypes: Sequence) -> object:
    """The C function ``symbol`` from the library ``build()`` returns, with
    its argument types set and an int (CUDA error code) result."""
    with _lock:
        fn = _symbols.get(symbol)
        if fn is None:
            fn = getattr(ctypes.CDLL(str(build())), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _symbols[symbol] = fn
        return fn
