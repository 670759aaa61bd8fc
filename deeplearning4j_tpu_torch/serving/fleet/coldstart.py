"""Cold start as load-not-build: the shared kernel-library directory.

Counterpart of ``deeplearning4j_tpu/serving/fleet/coldstart.py``. Scaling
out on an SLO burn-rate signal only works if a fresh replica is serving
before the traffic spike is over. The reference points every replica at
one JAX persistent compilation cache, so the first replica to see a
program pays its compile and every later one loads the executable.

The port's counterpart of that cache is the directory of kernel libraries
that ``ops/nvcc.py`` builds (``BUILD_DIR``, by default the git-ignored
``ops/_build/``): every replica points at one directory (the
``DL4J_TPU_COMPILE_CACHE`` environment knob, or ``compile_cache`` in the
replica spec), the first replica to need a kernel pays its ``nvcc`` build
and writes the library, and every later replica loads it.

What no cache answers: a replica's warm runs (each program's first eager
run, per process) and the decode step's CUDA graph captures (they bind
this process's addresses). Those are paid by every replica, cold or warm;
:func:`snapshot` reports them beside the builds.

Accounting: :func:`fresh_compile_count` is the number of ``nvcc`` builds
this process actually ran (a library found built is a cache hit). The
cold-start pin is that a replica joining a warm directory reaches ready
with zero fresh builds. On the CPU nothing is built and the count is 0.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_CACHE = "DL4J_TPU_COMPILE_CACHE"

_configured_dir: Optional[str] = None


def configure_compile_cache(path: Optional[str] = None) -> Optional[str]:
    """Point the kernel-library directory (``ops/nvcc.py`` ``BUILD_DIR``)
    at ``path``, or at ``$DL4J_TPU_COMPILE_CACHE`` when ``path`` is None.
    ``"0"`` or empty leaves the default ``ops/_build/``. Returns the
    configured directory, or None when nothing was configured. Call it
    before the first kernel is loaded: a library already loaded stays
    where it was found."""
    global _configured_dir
    cache = os.environ.get(ENV_CACHE, "") if path is None else path
    if not cache or cache == "0":
        return None
    os.makedirs(cache, exist_ok=True)
    from ...ops import nvcc
    nvcc.BUILD_DIR = Path(cache)
    _configured_dir = cache
    return cache


def configured_cache_dir() -> Optional[str]:
    return _configured_dir


def fresh_compile_count() -> int:
    """Kernel libraries this process built with ``nvcc`` (libraries found
    built in the directory excluded)."""
    from ...ops import nvcc
    return nvcc.build_counts()["built"]


def snapshot() -> dict:
    """The cold-start accounting block a replica publishes at ready time:
    the reference's keys (``compiles`` = libraries asked for, built or
    found; ``cache_hits`` = found; ``fresh_compiles`` = built) plus
    ``warm_runs``, the warm runs and graph captures no cache answers."""
    from ...ops import nvcc
    from ...telemetry import warm_run_count
    counts = nvcc.build_counts()
    return {"cache_dir": _configured_dir,
            "compiles": counts["built"] + counts["found"],
            "cache_hits": counts["found"],
            "fresh_compiles": counts["built"],
            "warm_runs": warm_run_count()}
