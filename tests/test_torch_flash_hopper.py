"""K1 (flash forward), K2 (dq) and K3 (dk/dv) as redesigned for Hopper:
how their sources are built and named, and what ``_launch`` hands them.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there, and checks that the bf16 ones issue ``wgmma``);
the ``cuda`` test below does the same at the tiles' edges and skips without
a card. On the CPU every wrapper takes its plain version, whose tests are
``test_torch_flash_attention*.py``.
"""
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
    """``shared_memory_bytes`` reaches K1's, K2's and K3's ``_smem`` entry,
    each from its own library, with (head dim, is_bf16)."""
    calls = []

    def fake_load(symbol, build, argtypes):
        calls.append((symbol, build))
        return lambda d, bf: 1000 * d + bf

    monkeypatch.setattr(fa, "load_symbol", fake_load)
    for symbol, build in (("dl4j_flash_attention_fwd", fa.build),
                          ("dl4j_flash_attention_bwd_dq", fa.build_bwd),
                          ("dl4j_flash_attention_bwd_dkv", fa.build_bwd_dkv)):
        assert fa.shared_memory_bytes(symbol, 128, torch.bfloat16) == 128001
        assert calls[-1] == (f"{symbol}_smem", build)


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
