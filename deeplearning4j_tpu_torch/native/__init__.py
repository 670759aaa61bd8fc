"""Native (C++) host components, built on demand and loaded via ctypes.

Counterpart of ``deeplearning4j_tpu/native/__init__.py``, with its two C++
sources copied byte for byte (``threshold_codec.cpp``, ``shard_reader.cpp``):
host code, not device kernels. The threshold codec is the host version of
``ops/compression.py`` ``threshold_encode`` (the same index order, signs and
residual); the shard reader serves ``datasets/export.py``'s ``.npz`` shards
from an mmap, each member's payload in one memcpy that holds no
interpreter lock.

Build: ``g++ -O3 -shared -fPIC`` into ``_build/`` (git-ignored) on first
use, never at import. Each library is named by the hash of its source, as
``ops/nvcc.py`` names the kernels' libraries, so an edited source rebuilds
and a stale library is never loaded; a build goes to a temporary name and
is renamed into place. ``available()`` and ``shard_reader_available()``
are False when there is no ``g++`` (the reference's contract: callers then
take the numpy or torch path).

A bfloat16 member (numpy stores it as a raw 2-byte void, ``|V2``) comes
back as a ``torch.bfloat16`` tensor, the reading of
``util/distributed_checkpoint.py``'s ``_from_numpy``; the reference views
it as ``ml_dtypes.bfloat16``, which the port does not use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}   # source -> library, or None


def library_path(src_name: str) -> str:
    """Where the library of ``src_name`` lives: named by its source's hash."""
    with open(os.path.join(_HERE, src_name), "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(src_name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")


def _compile(src_name: str) -> Optional[ctypes.CDLL]:
    """g++ -O3 -shared -fPIC unless the library exists; None when no
    toolchain builds it or it does not load."""
    out = library_path(src_name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC",
               os.path.join(_HERE, src_name), "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
    try:
        return ctypes.CDLL(out)
    except OSError:
        return None


def _load(src_name: str, declare) -> Optional[ctypes.CDLL]:
    """The library of ``src_name``, built and declared once a process."""
    with _LOCK:
        if src_name not in _LIBS:
            lib = _compile(src_name)
            if lib is not None:
                declare(lib)
            _LIBS[src_name] = lib
        return _LIBS[src_name]


def _declare_codec(lib: ctypes.CDLL) -> None:
    lib.threshold_encode.restype = ctypes.c_int
    lib.threshold_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8)]
    lib.threshold_decode.restype = None
    lib.threshold_decode.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64]


def _lib() -> Optional[ctypes.CDLL]:
    return _load("threshold_codec.cpp", _declare_codec)


def available() -> bool:
    """True when the native codec compiled and loaded on this host."""
    return _lib() is not None


def native_threshold_encode(residual: np.ndarray, threshold: float,
                            capacity: int):
    """C++ threshold encode. Mutates nothing: returns
    (indices[int32 capacity], signs[int8 capacity], count, new_residual).
    Semantics identical to ``ops/compression.py``
    ``threshold_encode``."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native threshold codec unavailable (no g++?); "
                           "use ops.compression.threshold_encode instead")
    res = np.ascontiguousarray(residual, np.float32).copy()
    n = res.shape[0]
    capacity = min(int(capacity), n)
    idx = np.zeros(capacity, np.int32)
    signs = np.zeros(capacity, np.int8)
    count = lib.threshold_encode(
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        ctypes.c_float(threshold), capacity,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        signs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return idx, signs, int(count), res


def native_threshold_decode(idx: np.ndarray, signs: np.ndarray,
                            threshold: float, size: int) -> np.ndarray:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native threshold codec unavailable (no g++?); "
                           "use ops.compression.threshold_decode instead")
    idx = np.ascontiguousarray(idx, np.int32)
    signs = np.ascontiguousarray(signs, np.int8)
    out = np.zeros(size, np.float32)
    lib.threshold_decode(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        signs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        idx.shape[0], ctypes.c_float(threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size)
    return out


# ------------------------------------------------------------ shard reader
def _declare_reader(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.sr_open.restype = c.c_void_p
    lib.sr_open.argtypes = [c.c_char_p]
    lib.sr_num_members.restype = c.c_int
    lib.sr_num_members.argtypes = [c.c_void_p]
    lib.sr_member_name.restype = c.c_char_p
    lib.sr_member_name.argtypes = [c.c_void_p, c.c_int]
    lib.sr_member_descr.restype = c.c_char_p
    lib.sr_member_descr.argtypes = [c.c_void_p, c.c_int]
    lib.sr_member_ndim.restype = c.c_int
    lib.sr_member_ndim.argtypes = [c.c_void_p, c.c_int]
    lib.sr_member_shape.restype = None
    lib.sr_member_shape.argtypes = [c.c_void_p, c.c_int,
                                    c.POINTER(c.c_int64)]
    lib.sr_member_fortran.restype = c.c_int
    lib.sr_member_fortran.argtypes = [c.c_void_p, c.c_int]
    lib.sr_member_nbytes.restype = c.c_int64
    lib.sr_member_nbytes.argtypes = [c.c_void_p, c.c_int]
    lib.sr_read.restype = c.c_int
    lib.sr_read.argtypes = [c.c_void_p, c.c_int, c.c_void_p]
    lib.sr_close.restype = None
    lib.sr_close.argtypes = [c.c_void_p]


def _sr_lib() -> Optional[ctypes.CDLL]:
    return _load("shard_reader.cpp", _declare_reader)


def shard_reader_available() -> bool:
    """True when the native shard reader compiled and loaded on this host."""
    return _sr_lib() is not None


class NativeNpzFile:
    """np.load-compatible view of an uncompressed .npz, served by the C++
    mmap reader (datasets/export.py's shard format): exposes ``.files`` and
    ``__getitem__`` like numpy's NpzFile, but the zip/npy headers are
    parsed natively and member payloads arrive via a single GIL-free
    memcpy. Context-manage or .close() to drop the mmap."""

    def __init__(self, path: str):
        lib = _sr_lib()
        if lib is None:
            raise RuntimeError("native shard reader unavailable (no g++?); "
                               "use numpy.load instead")
        self._lib = lib
        self._h = lib.sr_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"native shard reader could not parse {path!r} "
                          "(not an uncompressed npz?)")
        n = lib.sr_num_members(self._h)
        self.files = [lib.sr_member_name(self._h, i).decode()
                      for i in range(n)]
        self._index = {name: i for i, name in enumerate(self.files)}

    def __getitem__(self, name: str):
        i = self._index[name]
        lib = self._lib
        ndim = lib.sr_member_ndim(self._h, i)
        shape = (ctypes.c_int64 * max(ndim, 1))()
        if ndim:
            lib.sr_member_shape(self._h, i, shape)
        descr = lib.sr_member_descr(self._h, i).decode()
        order = "F" if lib.sr_member_fortran(self._h, i) else "C"
        out = np.empty(tuple(shape[:ndim]), dtype=np.dtype(descr),
                       order=order)
        nbytes = lib.sr_member_nbytes(self._h, i)
        if out.nbytes != nbytes:
            # parse_npy's element-size heuristic disagreed with numpy's
            # itemsize for this descr — an unchecked memcpy here would
            # silently corrupt, so refuse instead
            raise ValueError(
                f"member {name!r}: descr {descr!r} implies {out.nbytes} "
                f"bytes but native header says {nbytes}")
        lib.sr_read(self._h, i, out.ctypes.data_as(ctypes.c_void_p))
        if out.dtype.kind == "V":
            # np.savez stores a bfloat16 array as a raw 2-byte void ('|V2',
            # or '<V2'/'=V2' depending on the numpy version's byte-order
            # tag; np.load returns the same). ONLY those exact descrs are
            # recovered, as a torch.bfloat16 tensor (the reading of
            # util/distributed_checkpoint.py's _from_numpy); any other void
            # dtype (a structured record, '|V4', a big-endian '>V2', ...) is
            # not ours to guess at, so refuse rather than mis-type it.
            if descr in ("|V2", "<V2", "=V2"):
                return torch.from_numpy(out.view(np.int16)).view(
                    torch.bfloat16)
            raise ValueError(
                f"member {name!r}: void dtype descr {descr!r} is not "
                "the raw-bfloat16 '|V2' this shard format produces — "
                "refusing to reinterpret an unknown void layout")
        return out

    def close(self):
        if self._h:
            self._lib.sr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
