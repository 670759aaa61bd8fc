"""Pretrained-weight fetch/cache/checksum machinery.

Counterpart of ``deeplearning4j_tpu/models/pretrained.py``: ``adler32_of``
and ``fetch_cached`` are copied (stdlib only; a bad checksum is re-fetched
once), and ``init_pretrained`` restores the model zip through the port's
``util/serialization.py`` ``restore_model`` on the network's own device,
then copies its flat parameters in with ``set_params_flat``. The zip is the
reference's format, so a zip written by either package loads.

Reference: zoo/ZooModel.java:40-81 — initPretrained(PretrainedType) downloads
the weight archive into ~/.deeplearning4j/models/, verifies an Adler32
checksum (retrying the download once on mismatch), and restores the model.
No public weight hosting exists for this framework, so ``source`` is a local
path or any URL; the cache/checksum/restore contract is identical.
"""
from __future__ import annotations

import os
import shutil
import zlib
from typing import Optional

DEFAULT_CACHE = os.path.expanduser("~/.deeplearning4j_tpu/models")


def adler32_of(path: str) -> int:
    """Streaming Adler32 (reference uses java.util.zip.Adler32 over the zip)."""
    value = 1
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            value = zlib.adler32(chunk, value)
    return value & 0xFFFFFFFF


def fetch_cached(source: str, *, checksum: Optional[int] = None,
                 cache_dir: str = DEFAULT_CACHE,
                 filename: Optional[str] = None) -> str:
    """Copy/download ``source`` into the cache and verify its checksum
    (reference ZooModel.initPretrained download+verify loop :40-81).
    Returns the cached path. A cached file with a matching checksum is reused
    without touching the source; a corrupt cache entry is re-fetched once.
    """
    os.makedirs(cache_dir, exist_ok=True)
    name = filename or os.path.basename(source.rstrip("/")) or "model.zip"
    dest = os.path.join(cache_dir, name)

    def ok(path):
        return checksum is None or adler32_of(path) == checksum

    if os.path.exists(dest) and ok(dest):
        return dest
    for attempt in range(2):          # reference retries once on bad checksum
        _fetch(source, dest)
        if ok(dest):
            return dest
    raise IOError(f"Checksum mismatch for {source!r}: expected {checksum}, "
                  f"got {adler32_of(dest)} after retry "
                  f"(reference ZooModel behavior: fail after one re-download)")


def _fetch(source: str, dest: str) -> None:
    if os.path.exists(source):
        shutil.copyfile(source, dest)
        return
    if source.startswith(("http://", "https://")):
        import urllib.request
        try:
            with urllib.request.urlopen(source, timeout=60) as r, \
                    open(dest, "wb") as f:
                shutil.copyfileobj(r, f)
            return
        except OSError as e:
            raise IOError(f"Download failed for {source!r} (no network "
                          f"access?): {e}") from e
    raise FileNotFoundError(f"Pretrained source not found: {source!r}")


def init_pretrained(net, source: str, *, checksum: Optional[int] = None,
                    cache_dir: str = DEFAULT_CACHE):
    """Load pretrained weights from a model zip into ``net`` (shape-checked
    via the flat-parameter contract). The zip is whatever ``write_model``
    produced — config.json + coefficients.bin (+ updater state), the same
    layout the reference restores in initPretrained."""
    from ..util.serialization import restore_model
    path = fetch_cached(source, checksum=checksum, cache_dir=cache_dir)
    restored = restore_model(path, load_updater=False, device=net.device)
    flat = restored.params_flat()
    if not net.initialized:
        net.init()
    if int(flat.shape[0]) != net.num_params():
        raise ValueError(
            f"Pretrained checkpoint has {int(flat.shape[0])} params, model "
            f"expects {net.num_params()} — wrong architecture/config?")
    net.set_params_flat(flat)
    return net
