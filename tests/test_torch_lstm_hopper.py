"""K6 (the LSTM backward) as redesigned for Hopper: the host's plan
(``loop_plan``), how its source is built and named, and what the wrapper
hands the C entry point.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there at every phase-6 shape, and run to run); the
``cuda`` test below does the same at edge shapes and skips without a card.
On the CPU the wrapper takes its plain version, whose parity with the JAX
package is ``test_torch_lstm.py``'s. What runs here is the arithmetic of
the plan, which blocks own which hidden units and gate columns, and the
host path up to the C call.
"""
import _torch_threads  # noqa: F401
import functools
import hashlib
import itertools

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import lstm, nvcc

SMS = 132                       # an H100 SXM's SMs
# the clusters of 2 blocks an H100 holds at once at K6's shared memory,
# one block an SM (cudaOccupancyMaxActiveClusters), for each plan pair
H100_FIT = (66, 66)
FITS = [H100_FIT, (132, 132), (16, 16), (0, 66), (66, 0), (1, 1)]


def _owners(H, plan):
    """How many blocks of ``plan`` own each (hidden unit, gate column)
    cell of R, as the kernel cuts them: cluster p the units [p u, (p+1) u)
    below H, its block r the columns [r W, (r+1) W), W = 4H / q."""
    hits = np.zeros((H, 4 * H), dtype=np.int64)
    W = 4 * H // plan.q
    assert W * plan.q == 4 * H
    for p, r in itertools.product(range(plan.clusters), range(plan.q)):
        hits[p * plan.u:(p + 1) * plan.u, r * W:(r + 1) * W] += 1
    return hits


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("fit", FITS[:2])
@pytest.mark.parametrize("B", [1, 3, 32, 96])
def test_plan_owns_every_unit_and_gate_column_once(B, fit):
    for H in range(1, 1025):
        plan = lstm.loop_plan(H, B, SMS, fit)
        assert (plan.q, plan.u) in lstm.LOOP_CANDIDATES
        # every cluster owns at least one unit: none is idle
        assert (plan.clusters - 1) * plan.u < H <= plan.clusters * plan.u
        if H in (1, 3, 24, 256, 511, 512, 520, 777, 1024):
            assert (_owners(H, plan) == 1).all()


@pytest.mark.parametrize("fit", FITS)
def test_plan_never_takes_more_clusters_than_fit_or_blocks_than_sms(fit):
    for H, sms in itertools.product(range(1, 1025, 7), (132, 114, 66)):
        try:
            plan = lstm.loop_plan(H, 32, sms, fit)
        except ValueError:
            # no pair fits: then truly none does
            assert all(-(-H // u) > f or -(-H // u) * q > sms
                       for (q, u), f in zip(lstm.LOOP_CANDIDATES, fit))
            continue
        i = lstm.LOOP_CANDIDATES.index((plan.q, plan.u))
        assert plan.clusters <= fit[i]
        assert plan.blocks <= sms
        # no pair that fits has more blocks
        assert all(-(-H // u) * q <= plan.blocks
                   for (q, u), f in zip(lstm.LOOP_CANDIDATES, fit)
                   if -(-H // u) <= f and -(-H // u) * q <= sms)


def test_plan_on_an_h100_at_the_shapes_the_paths_use():
    """H 512 (the char-RNN) takes 64 clusters of 2 blocks of 8 units, as
    does H 520 (65); H 1024, where 8 units would need 128 clusters, 64 of
    16 units; past 66 clusters of 8 units the 16-unit pair takes over."""
    assert lstm.loop_plan(512, 32, SMS, H100_FIT) == lstm.LoopPlan(2, 8, 64)
    assert lstm.loop_plan(1024, 32, SMS, (0, 66)) == \
        lstm.LoopPlan(2, 16, 64)
    assert lstm.loop_plan(520, 32, SMS, H100_FIT) == lstm.LoopPlan(2, 8, 65)
    assert lstm.loop_plan(529, 32, SMS, H100_FIT) == \
        lstm.LoopPlan(2, 16, 34)
    assert lstm.loop_plan(20, 32, SMS, H100_FIT) == lstm.LoopPlan(2, 8, 3)


def test_plan_refuses_what_fits_nowhere():
    with pytest.raises(ValueError, match="no K6 plan fits"):
        lstm.loop_plan(1024, 32, SMS, (0, 0))
    with pytest.raises(ValueError, match="no K6 plan fits"):
        lstm.loop_plan(512, 32, 16, H100_FIT)
    with pytest.raises(ValueError, match="1 <= H, B"):
        lstm.loop_plan(0, 32, SMS, H100_FIT)
    with pytest.raises(ValueError, match="1 <= H, B"):
        lstm.loop_plan(512, 32, SMS, (66,))


def test_plan_is_worked_out_once_a_shape(monkeypatch):
    """A layer asks for the same shape on every step: the second ask costs
    a cache lookup, neither the search nor the library's layout query."""
    lstm.loop_plan.cache_clear()
    first = lstm.loop_plan(512, 32, SMS, H100_FIT)
    assert lstm.loop_plan(512, 32, SMS, H100_FIT) is first
    info = lstm.loop_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    asked = _fake_card(monkeypatch)
    lstm._bwd_plan(0, 512, 32, torch.float32)
    # one query a candidate pair, one for the layout of the pair chosen
    assert len(asked) == len(lstm.LOOP_CANDIDATES) + 1
    for _ in range(3):
        lstm._bwd_plan(0, 512, 32, torch.float32)
    assert len(asked) == len(lstm.LOOP_CANDIDATES) + 1


# ------------------------------------------------------ source and build
def test_k6_library_is_named_by_its_source_and_header():
    assert [h.name for h in nvcc._local_headers(lstm.BWD_SOURCE)] == \
        ["hopper_mma.cuh"]
    h = hashlib.sha256(lstm.BWD_SOURCE.read_bytes())
    h.update((lstm.BWD_SOURCE.parent / "hopper_mma.cuh").read_bytes())
    assert nvcc.library_path(lstm.BWD_SOURCE).name == \
        f"liblstm_bwd_{h.hexdigest()[:16]}.so"
    assert lstm._ENTRIES["dl4j_lstm_bwd"][0] is lstm.build_bwd
    assert lstm._ENTRIES["dl4j_lstm_bwd_layout"][0] is lstm.build_bwd


def test_the_source_compiles_the_plan_pairs():
    """The pairs the plan picks from are the ones the source dispatches on,
    and the backward is one kernel: no separate dR pass."""
    text = lstm.BWD_SOURCE.read_text()
    for _, u in lstm.LOOP_CANDIDATES:
        assert f"case {u}: return CALL(" in text
    assert text.count("__global__") == 1
    assert "cudaLaunchAttributeCooperative" in text
    assert "cudaOccupancyMaxActiveClusters" in text


# ---------------------------------------------------- wrapper, host path
def _fake_card(monkeypatch, fit=H100_FIT, scratch=0):
    """PyTorch's raw reads of the current card and its stream, the SM count
    and the library's layout query, as an H100 would answer them; returns
    the list of layout queries made."""
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1234 + index, raising=False)
    monkeypatch.setattr(lstm, "_sm_count", lambda index: SMS)

    def layout(index, H, B, dtype, q, u):
        asked.append((H, B, dtype, q, u))
        f = fit[lstm.LOOP_CANDIDATES.index((q, u))]
        return lstm.LoopLayout(150_000, scratch, f, 32, 1, -(-H // u) * q)

    monkeypatch.setattr(lstm, "_layout", layout)
    # a cache of this test's own, so no fake plan outlives it
    monkeypatch.setattr(lstm, "_bwd_plan", functools.lru_cache(maxsize=None)(
        lstm._bwd_plan.__wrapped__))
    return asked


class _Entry:
    """A stand-in C entry point that records its arguments."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def _operands(T, B, H, peep, masked, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        r.normal(size=shape).astype(np.float32))
    gates, R = f(T, B, 4 * H), f(H, 4 * H)
    cs, c_prev, h_prev, dhs = (f(T, B, H) for _ in range(4))
    dhT, dcT = f(B, H), f(B, H)
    mask = torch.from_numpy((r.random((T, B)) > 0.3).astype(np.float32)) \
        if masked else None
    peeps = tuple(f(H) for _ in range(3)) if peep else None
    return (gates, cs, c_prev, h_prev, dhs, R, dhT, dcT, mask, peeps)


@pytest.fixture
def entry(monkeypatch):
    fake = _Entry()
    monkeypatch.setattr(lstm, "load_symbol", lambda *a: fake)
    return fake


@pytest.mark.parametrize("peep, masked", [(False, False), (True, True)])
def test_launch_hands_the_entry_its_pointers_plan_and_stream(
        monkeypatch, entry, peep, masked):
    _fake_card(monkeypatch)
    T, B, H = 5, 3, 512
    ops = _operands(T, B, H, peep, masked)
    out = lstm._bwd_launch(*ops)
    assert [tuple(t.shape) for t in out] == \
        [(T, B, 4 * H), (B, H), (B, H), (H, 4 * H)] + [(1, H)] * (3 * peep)
    (args,) = entry.calls
    gates, cs, c_prev, h_prev, dhs, R, dhT, dcT, mask, peeps = ops
    ins = [gates, cs, c_prev, h_prev, dhs, R, dhT, dcT, mask,
           *(peeps or (None,) * 3)]
    outs = list(out[:4]) + (list(out[4:]) if peep else [None] * 3)
    want = [None if t is None else t.data_ptr() for t in ins + outs]
    assert list(args[:19]) == want
    assert args[19] is None                 # the layout asked no scratch
    assert args[20] is None                 # no trace
    plan = lstm.loop_plan(H, B, SMS, H100_FIT)
    assert args[21:] == (T, B, H, 0, plan.q, plan.u, 1234)


def test_launch_allocates_the_scratch_the_layout_asks(monkeypatch, entry):
    _fake_card(monkeypatch, scratch=4096)
    lstm._bwd_launch(*_operands(2, 8, 64, False, False))
    (args,) = entry.calls
    assert args[19] is not None


def test_launch_takes_a_given_plan(monkeypatch, entry):
    _fake_card(monkeypatch)
    plan = lstm.LoopPlan(2, 16, 32)
    lstm._bwd_launch(*_operands(2, 8, 512, True, False), plan=plan)
    assert entry.calls[0][25:27] == (2, 16)


@pytest.mark.parametrize("err, match", [
    (1, "CUDA error 1 "),
    (720, "CUDA error 720 \\(the plan's clusters cannot all be resident")])
def test_launch_raises_on_a_cuda_error(monkeypatch, err, match):
    _fake_card(monkeypatch)
    monkeypatch.setattr(lstm, "load_symbol", lambda *a: _Entry(err))
    with pytest.raises(RuntimeError, match=match):
        lstm._bwd_launch(*_operands(2, 3, 16, False, False))


def test_a_shape_no_plan_fits_raises_before_the_entry(monkeypatch, entry):
    _fake_card(monkeypatch, fit=(0, 0))
    with pytest.raises(ValueError, match="no K6 plan fits"):
        lstm._bwd_launch(*_operands(2, 3, 16, False, False))
    assert entry.calls == []


def test_launches_count_only_the_cuda_path(monkeypatch, entry):
    before = lstm.fused_lstm_bwd.launches
    ops = _operands(3, 2, 8, True, True)
    got = lstm.fused_lstm_bwd(*ops)
    for g, w in zip(got, lstm.lstm_bwd_reference(*ops)):
        assert torch.equal(g, w)
    assert lstm.fused_lstm_bwd.launches == before
    assert entry.calls == []


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(card, T, B, H, dtype, peep, masked, seed):
    """K6's inputs on the card as ``chip_smoke.py`` makes them: the plain
    forward's residuals from inputs at a xavier-initialised layer's scales,
    and cotangents."""
    r = np.random.default_rng(seed)
    f = lambda *shape, sc: (torch.from_numpy(
        r.normal(size=shape).astype(np.float32)) * sc).to(card, dtype)
    x, h0, c0, R = f(T, B, 4 * H, sc=0.3), f(B, H, sc=0.1), \
        f(B, H, sc=0.1), f(H, 4 * H, sc=0.05)
    mask = torch.from_numpy((r.random((T, B)) > 0.3).astype(
        np.float32)).to(card) if masked else None
    peeps = tuple(f(H, sc=0.2) for _ in range(3)) if peep else None
    res = lstm.lstm_fwd_reference(x, h0, c0, R, mask, peeps)[1:5]
    return (*res, f(T, B, H, sc=0.5), R, f(B, H, sc=0.5), f(B, H, sc=0.5),
            mask, peeps)


@pytest.mark.cuda
@pytest.mark.parametrize("T, B, H, dtype, peep, masked", [
    (1, 1, 512, torch.float32, True, False),
    (1, 3, 256, torch.float32, False, True),
    (7, 3, 512, torch.float32, True, True),
    (9, 1, 1024, torch.float32, True, False),
    (6, 5, 520, torch.float32, True, True),
    (4, 40, 512, torch.float32, False, False),
    (5, 2, 24, torch.float32, True, False),
    (3, 3, 520, torch.bfloat16, True, True),
    (2, 1, 1024, torch.bfloat16, False, False)])
def test_k6_equals_its_plain_version_at_edge_shapes(card, T, B, H, dtype,
                                                    peep, masked):
    """atol 3e-5 in f32 (tests/test_pallas_lstm.py's pin), 2e-2 in bf16;
    the same bits in a second run."""
    ops = _card_case(card, T, B, H, dtype, peep, masked, seed=T + B + H)
    got = lstm.fused_lstm_bwd(*ops)
    again = lstm.fused_lstm_bwd(*ops)
    want = lstm.lstm_bwd_reference(*ops)
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert (g.float() - w.float()).abs().max().item() <= tol
