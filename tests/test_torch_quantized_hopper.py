"""K8 (the int8 serving matmul) as redesigned for Hopper's integer tensor
cores: how its source is built and named, the host's tile plan, and what
the wrapper checks and hands the C entry point.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it bitwise
against its plain version there and checks that its SASS issues IMMA and
no IDP4A); the ``cuda`` test below does the same at the tiles' edges and
skips without a card. On the CPU the wrapper takes its plain version, whose
parity with the JAX package is ``test_torch_quantized.py``'s.
"""
import hashlib
import itertools

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import nvcc
from deeplearning4j_tpu_torch.ops.kernels import quantized as q

CSRC = q.SOURCE.parent
SERVED = [(M, K, N) for M in (8, 32, 256)
          for K, N in ((512, 512), (512, 256))]
COVER = [(1, 512, 512), (33, 512, 512), (33, 37, 70), (5, 515, 129),
         (64, 256, 256), (40, 512, 256), (17, 1040, 24), (300, 16, 8),
         (16, 4096, 40), (1, 1, 1), (1, 31, 1), (2, 33, 3), (129, 8192, 7)]


def _operands(M, K, N, seed=0):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(size=(M, K)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(K, N)).astype(np.float32))
    (x_q, x_s), (w_q, w_s) = q.quantize_rows(x), q.quantize_weights(w)
    return x_q.contiguous(), w_q.contiguous(), x_s, w_s


# -------------------------------------------------------- sources, builds
def test_k8_library_is_built_apart_and_named_by_its_source_and_header():
    assert [h.name for h in nvcc._local_headers(q.SOURCE)] == \
        ["hopper_mma.cuh"]
    h = hashlib.sha256(q.SOURCE.read_bytes())
    h.update((CSRC / "hopper_mma.cuh").read_bytes())
    assert nvcc.library_path(q.SOURCE).name == \
        f"libint8_matmul_{h.hexdigest()[:16]}.so"
    text = q.SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in text
    assert "__dp4a" not in text


# ------------------------------------------------------------- tile plan
@pytest.mark.parametrize("M, K, N", SERVED + COVER)
def test_plan_covers_every_output_and_every_k_once(M, K, N):
    splits, k_per = q.tile_plan(M, K, N)
    assert 1 <= splits <= q.MAX_SPLITS
    assert k_per % q.K_STEP == 0
    # the k ranges of the splits partition [0, K), none empty
    ranges = [(s * k_per, min(K, (s + 1) * k_per)) for s in range(splits)]
    assert all(lo < hi for lo, hi in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # the grid (splits, column tiles, row tiles) writes each output once
    seen = np.zeros((M, N), dtype=np.int64)
    for ty, tz in itertools.product(range(-(-N // q.BN)),
                                    range(-(-M // q.BM))):
        seen[tz * q.BM:(tz + 1) * q.BM, ty * q.BN:(ty + 1) * q.BN] += 1
    assert (seen == 1).all()
    if splits > 1:                  # a split holds at least two k-steps
        assert k_per >= 2 * q.K_STEP


@pytest.mark.parametrize("M, K, N", SERVED)
def test_every_served_product_fills_the_card(M, K, N):
    splits, _ = q.tile_plan(M, K, N)
    blocks = -(-M // q.BM) * -(-N // q.BN) * splits
    assert blocks >= q.MIN_BLOCKS
    # no more splits than the fill needs: M 256 runs unsplit
    assert splits == 1 or blocks // 2 < q.MIN_BLOCKS
    assert q.tile_plan(256, 512, 512) == (1, 512)


# ---------------------------------------------------- wrapper, host path
class _Fake:
    """A stand-in C entry point that records the arguments in the array it
    is handed."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __call__(self, address):
        self.calls.append(tuple(q._ARGS.from_address(address)))
        return self.err


def _card_calls(monkeypatch, device=0):
    """PyTorch's raw reads of the current card and its stream, as a card
    would answer them: card ``device``, stream 1234 + its index."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: device,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234 + index, raising=False)


@pytest.fixture
def fake_entry(monkeypatch):
    fake = _Fake()
    monkeypatch.setattr(q, "_entry", [fake])
    _card_calls(monkeypatch)
    return fake


def test_launch_hands_the_entry_its_arguments_plan_and_stream(fake_entry):
    M, K, N = 33, 37, 70
    x_q, w_q, x_s, w_s = _operands(M, K, N)
    out = q._launch(x_q, w_q, x_s, w_s)
    assert out.shape == (M, N) and out.dtype == torch.float32
    (args,) = fake_entry.calls
    assert args[:5] == (x_q.data_ptr(), w_q.data_ptr(), x_s.data_ptr(),
                        w_s.data_ptr(), out.data_ptr())
    assert args[5:10] == (M, K, N, *q.tile_plan(M, K, N))
    assert args[10] == 1234             # the current card's stream


def test_the_entry_point_is_resolved_once(monkeypatch):
    loads = []

    def fake_load(symbol, build, argtypes):
        loads.append((symbol, build, len(argtypes)))
        return _Fake()

    monkeypatch.setattr(q, "load_symbol", fake_load)
    monkeypatch.setattr(q, "_entry", [])
    _card_calls(monkeypatch)
    args = _operands(8, 64, 32)
    for _ in range(3):
        q._launch(*args)
    # one pointer: the array of the eleven arguments
    assert loads == [("dl4j_int8_matmul", q.build, 1)]


def test_launch_raises_on_a_cuda_error(monkeypatch):
    monkeypatch.setattr(q, "_entry", [_Fake(err=1)])
    _card_calls(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        q._launch(*_operands(8, 64, 32))


def _bad_operands():
    """(what is wrong, operands) for every refusal the wrapper makes."""
    x_q, w_q, x_s, w_s = _operands(8, 64, 32)
    yield "x_q dtype", (x_q.to(torch.int32), w_q, x_s, w_s)
    yield "w_q dtype", (x_q, w_q.float(), x_s, w_s)
    yield "x_scale dtype", (x_q, w_q, x_s.double(), w_s)
    yield "w_scale dtype", (x_q, w_q, x_s, w_s.half())
    yield "x_q rank", (x_q.reshape(-1), w_q, x_s, w_s)
    yield "w_q rank", (x_q, w_q.reshape(-1), x_s, w_s)
    yield "K mismatch", (x_q, w_q[:63].contiguous(), x_s, w_s)
    yield "x_scale length", (x_q, w_q, x_s[:7], w_s)
    yield "w_scale length", (x_q, w_q, x_s, w_s[:31])
    yield "x_scale rank", (x_q, w_q, x_s[:, None], w_s)
    yield "w_scale rank", (x_q, w_q, x_s, w_s[None, :])
    yield "x_q contiguity", (x_q.t().contiguous().t(), w_q, x_s, w_s)
    yield "w_q contiguity", (x_q, w_q[:, ::2], x_s, w_s[::2].contiguous())
    yield "x_scale contiguity", (x_q, w_q, torch.zeros(16)[::2], w_s)
    yield "w_q device", (x_q, w_q.to("meta"), x_s, w_s)
    yield "w_scale device", (x_q, w_q, x_s, w_s.to("meta"))
    yield "empty K", (x_q[:, :0], w_q[:0], x_s, w_s)


@pytest.mark.parametrize("what, args", list(_bad_operands()),
                         ids=[w for w, _ in _bad_operands()])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fake_entry, what,
                                                           args):
    with pytest.raises(ValueError):
        q._launch(*args)
    assert fake_entry.calls == []


def test_operands_of_2_31_elements_are_refused(fake_entry):
    meta = dict(device="meta")          # shapes without memory
    x_q = torch.empty(2 ** 16, 2 ** 15, dtype=torch.int8, **meta)
    w_q = torch.empty(2 ** 15, 1, dtype=torch.int8, **meta)
    with pytest.raises(ValueError, match="2\\^31"):
        q._launch(x_q, w_q, torch.empty(2 ** 16, **meta),
                  torch.empty(1, **meta))
    assert fake_entry.calls == []


def test_launches_count_only_the_cuda_path(monkeypatch):
    args = _operands(4, 16, 8)
    before = q.int8_matmul_fused.launches
    assert torch.equal(q.int8_matmul_fused(*args),
                       q.int8_matmul_plain(*args))
    assert q.int8_matmul_fused.launches == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        q.int8_matmul_fused(*(t.to("meta") for t in args))
    assert q.int8_matmul_fused.launches == before


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M, K, N", [(1, 32, 8), (15, 64, 31), (16, 512, 32),
                                     (17, 544, 33), (8, 512, 256),
                                     (32, 512, 512), (256, 512, 512),
                                     (33, 37, 70), (5, 515, 129),
                                     (16, 4096, 40), (129, 8192, 7)])
def test_k8_is_bitwise_its_plain_version_at_tile_edges(card, M, K, N):
    args = tuple(t.to(card) for t in _operands(M, K, N, seed=M + K + N))
    got = q.int8_matmul_fused(*args)
    assert torch.equal(got, q.int8_matmul_plain(*args))
    # a view of x off a 16-byte boundary takes the byte-wise staging
    x_q = args[0]
    base = torch.zeros(M * K + 1, dtype=torch.int8, device=card)
    base[1:] = x_q.reshape(-1)
    shifted = base[1:].view(M, K)
    assert torch.equal(q.int8_matmul_fused(shifted, *args[1:]), got)
