"""K1 (flash forward), K2 (dq), K3 (dk/dv) and K4 (the ring hop's carry
update) as redesigned for Hopper: how their sources are built and named,
and what ``_launch`` and K4's wrapper hand them.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there, and checks that the bf16 ones issue ``wgmma``);
the ``cuda`` test below does the same at the tiles' edges and skips without
a card. On the CPU every wrapper takes its plain version, whose tests are
``test_torch_flash_attention*.py``.
"""
import _torch_threads  # noqa: F401
import hashlib
import math
import re
import subprocess

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import nvcc

CSRC = fa.SOURCE.parent


def _inputs(seed, BH, T, D, dtype):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.normal(size=(BH, T, D)).astype(np.float32))
            .to(dtype) for _ in range(4))


# -------------------------------------------------------- sources, builds
def test_k3_library_is_built_apart_and_named_by_its_hash():
    h = hashlib.sha256(fa.DKV_SOURCE.read_bytes())
    h.update((CSRC / "hopper_mma.cuh").read_bytes())
    path = nvcc.library_path(fa.DKV_SOURCE)
    assert path.name == f"libflash_attention_bwd_dkv_{h.hexdigest()[:16]}.so"
    # K2's library is apart from K3's and named by its own source and the
    # shared header it now includes
    h2 = hashlib.sha256(fa.BWD_SOURCE.read_bytes())
    h2.update((CSRC / "hopper_mma.cuh").read_bytes())
    assert fa.bwd_library_path().name == \
        f"libflash_attention_bwd_{h2.hexdigest()[:16]}.so"
    assert fa.bwd_library_path() != path


def test_each_entry_point_loads_from_its_own_library():
    entries = fa._ENTRIES
    assert entries["dl4j_flash_attention_fwd"][0] is fa.build
    assert entries["dl4j_flash_attention_bwd_dq"][0] is fa.build_bwd
    assert entries["dl4j_flash_attention_bwd_dkv"][0] is fa.build_bwd_dkv
    assert entries["dl4j_flash_attention_fwd_smem"][0] is fa.build
    assert entries["dl4j_flash_attention_bwd_dq_smem"][0] is fa.build_bwd
    assert entries["dl4j_flash_attention_bwd_dkv_smem"][0] is \
        fa.build_bwd_dkv
    text = {p.name: p.read_text() for p in CSRC.glob("*.cu")}
    defined = {name for name, t in text.items()
               if "dl4j_flash_attention_bwd_dkv" in
               re.findall(r'extern "C" int (\w+)\(', t)}
    assert defined == {"flash_attention_bwd_dkv.cu"}


def test_every_redesigned_kernel_reports_its_shared_memory(monkeypatch):
    """``shared_memory_bytes`` reaches K1's, K2's, K3's and K4's ``_smem`` entry,
    each from its own library, with (head dim, is_bf16)."""
    calls = []

    def fake_load(symbol, build, argtypes):
        calls.append((symbol, build))
        return lambda d, bf: 1000 * d + bf

    monkeypatch.setattr(fa, "load_symbol", fake_load)
    for symbol, build in (("dl4j_flash_attention_fwd", fa.build),
                          ("dl4j_flash_attention_bwd_dq", fa.build_bwd),
                          ("dl4j_flash_attention_bwd_dkv", fa.build_bwd_dkv),
                          ("dl4j_flash_block_update",
                           fa.build_block_update)):
        assert fa.shared_memory_bytes(symbol, 128, torch.bfloat16) == 128001
        assert calls[-1] == (f"{symbol}_smem", build)


def test_k4_library_is_built_apart_and_named_by_its_source_and_headers():
    """K4 and K1 include the forward's shared key loop and, through it and
    directly, the wgmma header; each library is named by its source and
    every local header it reaches."""
    headers = ["flash_fwd_tile.cuh", "hopper_mma.cuh"]
    for source, stem in ((fa.BLOCK_UPDATE_SOURCE, "flash_block_update"),
                         (fa.SOURCE, "flash_attention_fwd")):
        assert [p.name for p in nvcc._local_headers(source)] == headers
        h = hashlib.sha256(source.read_bytes())
        for name in headers:
            h.update((CSRC / name).read_bytes())
        assert nvcc.library_path(source).name == \
            f"lib{stem}_{h.hexdigest()[:16]}.so"
    assert nvcc.library_path(fa.BLOCK_UPDATE_SOURCE) != fa.library_path()
    assert fa._ENTRIES["dl4j_flash_block_update"][0] is fa.build_block_update
    assert fa._ENTRIES["dl4j_flash_block_update_smem"][0] is \
        fa.build_block_update


def test_k1_and_k4_share_one_copy_of_the_key_loop():
    """The key loop's bodies are defined in the shared header alone, and
    both kernels call them."""
    loop = ("bf16_key_tile", "f32_pass")
    for path in CSRC.glob("*.cu"):
        text = path.read_text()
        for name in loop:
            assert not re.search(rf"void {name}\(", text), (path.name, name)
    header = (CSRC / "flash_fwd_tile.cuh").read_text()
    for name in loop:
        assert re.search(rf"void {name}\(", header)
        for source in (fa.SOURCE, fa.BLOCK_UPDATE_SOURCE):
            assert f"dl4j_fwd::{name}<D>(" in source.read_text()


def test_a_local_header_included_by_a_header_rebuilds(tmp_path):
    src, outer, inner = (tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh"))
    src.write_text('#include "a.cuh"\nint x;\n')
    outer.write_text('#pragma once\n#include "b.cuh"\n')
    inner.write_text("// v1\n")
    assert [p.name for p in nvcc._local_headers(src)] == ["a.cuh", "b.cuh"]
    before = nvcc.library_path(src)
    inner.write_text("// v2\n")
    assert nvcc.library_path(src) != before


def test_k4_wrapper_hands_the_kernel_its_arguments(monkeypatch):
    """Pointers (a misaligned view copied first), BH, Tq, Tk, D, the dtype
    and mode flags, the scale and the stream; the carry comes back in fresh
    tensors."""
    seen = []

    class FakeStream:
        cuda_stream = 99

    def fake_kernel(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(fa, "_on_cpu", lambda t: False)
    monkeypatch.setattr(fa, "_kernel", lambda symbol: fake_kernel)
    monkeypatch.setattr(fa.flash_block_update, "launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: FakeStream())
    BH, Tq, Tk, D = 2, 256, 384, 64
    base = torch.zeros(BH * Tq * D + 1)
    q = base[1:].view(BH, Tq, D)                   # 4 bytes off
    k, v = torch.zeros(BH, Tk, D), torch.zeros(BH, Tk, D)
    acc, m, l = (torch.zeros(BH, Tq, D), torch.full((BH, Tq), -1e30),
                 torch.zeros(BH, Tq))
    outs = fa.flash_block_update(acc, m, l, q, k, v, causal=False,
                                 scale=0.125)
    (args,) = seen
    assert args[0] % 16 == 0 and args[0] != q.data_ptr()
    assert args[1:6] == tuple(t.data_ptr() for t in (k, v, acc, m, l))
    assert args[6:9] == tuple(t.data_ptr() for t in outs)
    assert args[9:] == (BH, Tq, Tk, D, 0, 0, 0.125, 99)
    assert [t.shape for t in outs] == [acc.shape, m.shape, l.shape]
    assert fa.flash_block_update.launches == 1
    with pytest.raises(ValueError, match="causal is the diagonal hop"):
        fa.flash_block_update(acc, m, l, q, k, v, causal=True, scale=0.125)


def test_library_is_rebuilt_when_an_included_header_changes(tmp_path):
    src, header = tmp_path / "k.cu", tmp_path / "mma.cuh"
    src.write_text('#include <cstdint>\n#include "mma.cuh"\nint x;\n')
    header.write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    before = nvcc.library_path(src)
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert nvcc.library_path(src) == before
    header.write_text("// v2\n")
    assert nvcc.library_path(src) != before
    assert nvcc.library_path(src).name.startswith("libk_")


def test_build_log_starts_with_the_build_seconds(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("int x;\n")
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "nvcc")

    def fake_run(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info: Used 8 "
                                           "registers\n")
    monkeypatch.setattr(nvcc.subprocess, "run", fake_run)
    lib = nvcc.build_library(src)
    assert lib.exists() and lib.parent == tmp_path / "_build"
    lines = lib.with_suffix(".log").read_text().splitlines()
    assert re.fullmatch(r"# nvcc \d+\.\d s", lines[0])
    assert lines[1].startswith("nvcc -gencode arch=compute_90a,code=sm_90a")
    assert lines[-1] == "ptxas info: Used 8 registers"


def test_cuda_tools_are_found_beside_nvcc(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").touch()
    (bin_dir / "cuobjdump").touch()
    monkeypatch.setattr(nvcc, "_nvcc", lambda: str(bin_dir / "nvcc"))
    assert nvcc.cuda_tool("cuobjdump") == str((bin_dir / "cuobjdump")
                                              .resolve())
    with pytest.raises(RuntimeError, match="nvdisasm not found beside nvcc"):
        nvcc.cuda_tool("nvdisasm")


def test_k1_and_k3_copy_misaligned_views_before_launch(monkeypatch):
    """The kernels (K2 too) copy rows in 16-byte pieces; ``_launch`` hands
    them a fresh copy of a view that starts off a 16-byte boundary."""
    seen = []

    class FakeStream:
        cuda_stream = 0

    def fake_kernel(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(fa, "_kernel", lambda symbol: fake_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: FakeStream())
    base = torch.zeros(2 * 256 * 64 + 1)
    q = base[1:].view(2, 256, 64)                  # 4 bytes off
    assert q.data_ptr() % 16 == 4
    k = torch.zeros(2, 256, 64)
    o, lse = torch.empty_like(k), torch.empty(2, 256)
    fa._launch("dl4j_flash_attention_fwd", [q, k, k], None, [o, lse],
               causal=True, scale=0.125)
    ptrs = seen[0][:3]
    assert all(p % 16 == 0 for p in ptrs)
    assert ptrs[0] != q.data_ptr() and ptrs[1] == k.data_ptr()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH, T, D", [(3, 320, 64), (8, 1000, 64),
                                      (4, 1000, 256), (3, 200, 128)])
def test_kernels_equal_plain_at_tile_edges_on_the_card(card, dtype, BH, T,
                                                       D):
    q, k, v, do = (t.to(card) for t in _inputs(8, BH, T, D, dtype))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    ro, rlse = fa.flash_attention_reference(q, k, v, True, scale)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (o.float() - ro.float()).abs().max() <= tol
    assert (lse - rlse).abs().max() <= tol
    delta = (do.float() * o.float()).sum(dim=-1)
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True,
                                     scale=scale),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=True,
                                       scale=scale))
    want = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, True,
                                            scale)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert ((g.float() - w.float()).abs().max()
                / w.float().abs().max()) <= rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH, Tq, Tk, D, causal", [
    (3, 320, 320, 64, True), (2, 200, 200, 96, True), (2, 130, 70, 128, False),
    (3, 64, 192, 64, False), (1, 1000, 1000, 256, True),
    (2, 128, 1000, 256, False), (8, 2048, 2048, 64, True)])
def test_k4_equals_plain_at_tile_edges_on_the_card(card, dtype, BH, Tq, Tk,
                                                    D, causal):
    r = np.random.default_rng(BH + Tq + Tk + D)

    def rnd(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(
            dtype).to(card)

    q, k, v, kp, vp = rnd(BH, Tq, D), rnd(BH, Tk, D), rnd(BH, Tk, D), \
        rnd(BH, Tk, D), rnd(BH, Tk, D)
    scale = 1.0 / math.sqrt(D)
    empty = (torch.zeros(BH, Tq, D, device=card),
             torch.full((BH, Tq), -1e30, device=card),
             torch.zeros(BH, Tq, device=card))
    earlier = fa.flash_block_update_reference(*empty, q, kp, vp, False, scale)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for carry in (empty, earlier):
        got = fa.flash_block_update(*carry, q, k, v, causal=causal,
                                    scale=scale)
        want = fa.flash_block_update_reference(*carry, q, k, v, causal, scale)
        assert ((got[0] / got[2][..., None])
                - (want[0] / want[2][..., None])).abs().max() <= tol
        assert (got[1] - want[1]).abs().max() <= 1e-3
        assert ((got[2] - want[2]).abs().max()
                / want[2].abs().max()) <= (1e-4 if dtype == torch.float32
                                           else 2e-2)
