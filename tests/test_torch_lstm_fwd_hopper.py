"""K5 (the LSTM forward) as redesigned for Hopper: the host's plan
(``fwd_plan``), how its source is built and named, and what the wrapper
hands the C entry point.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there at every phase-6 shape, and run to run); the
``cuda`` test below does the same at edge shapes and skips without a card.
On the CPU the wrapper takes its plain version, whose parity with the JAX
package is ``test_torch_lstm.py``'s. What runs here is the arithmetic of
the plan, which blocks own which hidden units and which rows of R, and the
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
# the clusters of 2 blocks an H100 holds at once at K5's shared memory
# (one block an SM; cudaOccupancyMaxActiveClusters), one count for each
# pair of FWD_CANDIDATES
H100_FIT = (66, 66)
FITS = [H100_FIT, (132, 132), (16, 16), (0, 66), (66, 0), (1, 1)]


def _owners(H, plan):
    """How many blocks of ``plan`` hold each (k row, hidden unit) of R (a
    unit standing for its four gate columns), as the kernel cuts them:
    cluster p the units [p u, (p+1) u) below H, its block r the rows
    [r k, (r+1) k) below H."""
    hits = np.zeros((H, H), dtype=np.int64)
    k = plan.k_rows(H)
    assert k % 4 == 0 and plan.q * k >= H
    for p, r in itertools.product(range(plan.clusters), range(plan.q)):
        hits[r * k:(r + 1) * k, p * plan.u:(p + 1) * plan.u] += 1
    return hits


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("fit", FITS[:2])
@pytest.mark.parametrize("B", [1, 3, 32, 96])
def test_plan_owns_every_unit_and_k_row_once(B, fit):
    for H in range(1, 1025):
        plan = lstm.fwd_plan(H, B, SMS, fit)
        assert (plan.q, plan.u) in lstm.FWD_CANDIDATES
        # every cluster owns at least one unit: none is idle
        assert (plan.clusters - 1) * plan.u < H <= plan.clusters * plan.u
        if H in (1, 3, 24, 37, 256, 511, 512, 520, 777, 1024):
            assert (_owners(H, plan) == 1).all()


@pytest.mark.parametrize("fit", FITS)
def test_plan_never_takes_more_clusters_than_fit_or_blocks_than_sms(fit):
    for H, sms in itertools.product(range(1, 1025, 7), (132, 114, 66)):
        try:
            plan = lstm.fwd_plan(H, 8, sms, fit)
        except ValueError:
            # no pair fits: then truly none does
            assert all(-(-H // u) > f or -(-H // u) * q > sms
                       for (q, u), f in zip(lstm.FWD_CANDIDATES, fit))
            continue
        i = lstm.FWD_CANDIDATES.index((plan.q, plan.u))
        assert plan.clusters <= fit[i]
        assert plan.blocks <= sms
        # no pair that fits has more blocks
        assert all(-(-H // u) * q <= plan.blocks
                   for (q, u), f in zip(lstm.FWD_CANDIDATES, fit)
                   if -(-H // u) <= f and -(-H // u) * q <= sms)


def test_plan_on_an_h100_at_the_shapes_the_paths_use():
    """H 512 (the char-RNN) takes 64 clusters of 2 blocks of 8 units, 256
    rows of R a block; H 520 65 of them (a last cluster of 8 units, 260
    rows a block); H 1024, where 8 units would need 128 clusters, 64 of 16
    units; past 66 clusters of 8 units the 16-unit pair of 2 blocks takes
    over."""
    plan = lstm.fwd_plan(512, 32, SMS, H100_FIT)
    assert plan == lstm.FwdPlan(2, 8, 64) and plan.k_rows(512) == 256
    assert lstm.fwd_plan(512, 1, SMS, H100_FIT) == plan
    plan = lstm.fwd_plan(520, 32, SMS, H100_FIT)
    assert plan == lstm.FwdPlan(2, 8, 65) and plan.k_rows(520) == 260
    assert lstm.fwd_plan(1024, 32, SMS, H100_FIT) == lstm.FwdPlan(2, 16, 64)
    assert lstm.fwd_plan(529, 32, SMS, H100_FIT) == lstm.FwdPlan(2, 16, 34)
    assert lstm.FwdPlan(2, 8, 1).k_rows(1) == 4
    assert lstm.FwdPlan(2, 8, 98).k_rows(777) == 392


def test_plan_refuses_what_fits_nowhere():
    with pytest.raises(ValueError, match="no K5 plan fits"):
        lstm.fwd_plan(1024, 32, SMS, (0, 0))
    with pytest.raises(ValueError, match="no K5 plan fits"):
        lstm.fwd_plan(512, 32, 16, H100_FIT)
    with pytest.raises(ValueError, match="K5 plans 1 <= H, B"):
        lstm.fwd_plan(0, 32, SMS, H100_FIT)
    with pytest.raises(ValueError, match="K5 plans 1 <= H, B"):
        lstm.fwd_plan(512, 0, SMS, H100_FIT)
    with pytest.raises(ValueError, match="K5 plans 1 <= H, B"):
        lstm.fwd_plan(512, 32, SMS, (66,))


def test_plan_is_worked_out_once_a_shape(monkeypatch):
    """A layer asks for the same shape on every step: the second ask costs
    a cache lookup, neither the search nor the library's layout query."""
    lstm.fwd_plan.cache_clear()
    first = lstm.fwd_plan(512, 32, SMS, H100_FIT)
    assert lstm.fwd_plan(512, 32, SMS, H100_FIT) is first
    info = lstm.fwd_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    asked = _fake_card(monkeypatch)
    lstm._fwd_plan(0, 512, 32, torch.float32)
    # one query a candidate pair, one for the layout of the pair chosen
    assert len(asked) == len(lstm.FWD_CANDIDATES) + 1
    for _ in range(3):
        lstm._fwd_plan(0, 512, 32, torch.float32)
    assert len(asked) == len(lstm.FWD_CANDIDATES) + 1
    lstm._fwd_plan(0, 512, 8, torch.float32)        # another shape asks
    assert len(asked) == 2 * (len(lstm.FWD_CANDIDATES) + 1)


# ------------------------------------------------------ source and build
def test_k5_library_is_named_by_its_source_and_header():
    assert [h.name for h in nvcc._local_headers(lstm.FWD_SOURCE)] == \
        ["hopper_mma.cuh"]
    h = hashlib.sha256(lstm.FWD_SOURCE.read_bytes())
    h.update((lstm.FWD_SOURCE.parent / "hopper_mma.cuh").read_bytes())
    assert nvcc.library_path(lstm.FWD_SOURCE).name == \
        f"liblstm_fwd_{h.hexdigest()[:16]}.so"
    assert lstm._ENTRIES["dl4j_lstm_fwd"][0] is lstm.build_fwd
    assert lstm._ENTRIES["dl4j_lstm_fwd_layout"][0] is lstm.build_fwd


def test_the_source_compiles_the_plan_units():
    """The units the plan picks from are the ones the source dispatches
    on, and the forward is one kernel launched as a cooperative cluster
    grid that the library sizes."""
    text = lstm.FWD_SOURCE.read_text()
    for u in {u for _, u in lstm.FWD_CANDIDATES}:
        assert f"case {u}: return CALL({u});" in text
    assert {q for q, _ in lstm.FWD_CANDIDATES} == {2}
    assert text.count("q != 2") == 2        # the layout query and the launch
    assert text.count("__global__") == 1
    assert "cudaLaunchAttributeCooperative" in text
    assert "cudaOccupancyMaxActiveClusters" in text
    assert "cudaErrorCooperativeLaunchTooLarge" in text


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
        f = fit[lstm.FWD_CANDIDATES.index((q, u))]
        return lstm.LoopLayout(120_000, scratch, f, 32, 1, -(-H // u) * q)

    monkeypatch.setattr(lstm, "_fwd_layout", layout)
    # a cache of this test's own, so no fake plan outlives it
    monkeypatch.setattr(lstm, "_fwd_plan", functools.lru_cache(maxsize=None)(
        lstm._fwd_plan.__wrapped__))
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
    x, h0, c0, R = f(T, B, 4 * H), f(B, H), f(B, H), f(H, 4 * H)
    mask = torch.from_numpy((r.random((T, B)) > 0.3).astype(np.float32)) \
        if masked else None
    peeps = tuple(f(H) for _ in range(3)) if peep else None
    return (x, h0, c0, R, mask, peeps)


@pytest.fixture
def entry(monkeypatch):
    fake = _Entry()
    monkeypatch.setattr(lstm, "load_symbol", lambda *a: fake)
    return fake


@pytest.mark.parametrize("T, peep, masked", [(5, False, False),
                                             (4, True, True),
                                             (1, True, False)])
def test_launch_hands_the_entry_its_pointers_plan_and_stream(
        monkeypatch, entry, T, peep, masked):
    _fake_card(monkeypatch)
    B, H = 3, 512
    ops = _operands(T, B, H, peep, masked)
    out = lstm._fwd_launch(*ops)
    assert [tuple(t.shape) for t in out] == \
        [(T, B, H), (T, B, 4 * H)] + [(T, B, H)] * 3 + [(B, H)] * 2
    (args,) = entry.calls
    x, h0, c0, R, mask, peeps = ops
    ins = [x, R, h0, c0, mask, *(peeps or (None,) * 3)]
    hs, gates, cs, c_prev, h_prev, hT, cT = out
    outs = [hs, gates, cs, c_prev, h_prev, hT, cT]
    want = [None if t is None else t.data_ptr() for t in ins + outs]
    assert list(args[:15]) == want
    # the exchange of h: a call of more than one step has one
    assert (args[15] is None) == (T == 1)
    assert args[16] is None                 # the layout asked no scratch
    assert args[17] is None                 # no trace
    plan = lstm.fwd_plan(H, B, SMS, H100_FIT)
    assert args[18:] == (T, B, H, 0, plan.q, plan.u, 1234)


def test_launch_allocates_the_scratch_the_layout_asks(monkeypatch, entry):
    _fake_card(monkeypatch, scratch=4096)
    lstm._fwd_launch(*_operands(2, 8, 64, False, False))
    (args,) = entry.calls
    assert args[16] is not None


def test_launch_takes_a_given_plan_and_trace(monkeypatch, entry):
    _fake_card(monkeypatch)
    plan = lstm.FwdPlan(2, 16, 32)
    trace = torch.zeros(3, 8, dtype=torch.int64)       # T + 1 rows
    lstm._fwd_launch(*_operands(2, 8, 512, True, False), plan=plan,
                     trace=trace)
    args = entry.calls[0]
    assert args[17] == trace.data_ptr()
    assert args[22:24] == (2, 16)


@pytest.mark.parametrize("err, match", [
    (1, "CUDA error 1 "),
    (720, "CUDA error 720 \\(the plan's clusters cannot all be resident")])
def test_launch_raises_on_a_cuda_error(monkeypatch, err, match):
    _fake_card(monkeypatch)
    monkeypatch.setattr(lstm, "load_symbol", lambda *a: _Entry(err))
    with pytest.raises(RuntimeError, match=match):
        lstm._fwd_launch(*_operands(2, 3, 16, False, False))


def test_a_shape_no_plan_fits_raises_before_the_entry(monkeypatch, entry):
    _fake_card(monkeypatch, fit=(0, 0))
    with pytest.raises(ValueError, match="no K5 plan fits"):
        lstm._fwd_launch(*_operands(2, 3, 16, False, False))
    assert entry.calls == []


def test_launches_count_only_the_cuda_path(monkeypatch, entry):
    monkeypatch.setattr(lstm.fused_lstm_fwd, "launches",
                        lstm.fused_lstm_fwd.launches)
    before = lstm.fused_lstm_fwd.launches
    ops = _operands(3, 2, 8, True, True)
    got = lstm.fused_lstm_fwd(*ops)
    for g, w in zip(got, lstm.lstm_fwd_reference(*ops)):
        assert torch.equal(g, w)
    assert lstm.fused_lstm_fwd.launches == before
    assert entry.calls == []


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_case(card, T, B, H, dtype, peep, masked, seed):
    """K5's inputs on the card at the scales of a xavier-initialised
    layer, as ``chip_smoke.py`` makes them."""
    r = np.random.default_rng(seed)
    f = lambda *shape, sc: (torch.from_numpy(
        r.normal(size=shape).astype(np.float32)) * sc).to(card, dtype)
    x, h0, c0, R = f(T, B, 4 * H, sc=0.3), f(B, H, sc=0.1), \
        f(B, H, sc=0.1), f(H, 4 * H, sc=0.05)
    mask = torch.from_numpy((r.random((T, B)) > 0.3).astype(
        np.float32)).to(card) if masked else None
    peeps = tuple(f(H, sc=0.2) for _ in range(3)) if peep else None
    return (x, h0, c0, R, mask, peeps)


@pytest.mark.cuda
@pytest.mark.parametrize("T, B, H, dtype, peep, masked", [
    (1, 1, 512, torch.float32, True, False),
    (1, 8, 512, torch.bfloat16, True, False),
    (1, 3, 37, torch.float32, False, True),
    (7, 3, 512, torch.float32, True, True),
    (9, 1, 1024, torch.float32, True, False),
    (6, 5, 520, torch.float32, True, True),
    (4, 40, 512, torch.float32, False, False),
    (5, 2, 24, torch.float32, True, False),
    (4, 6, 777, torch.float32, True, True),
    (3, 300, 256, torch.float32, True, True),
    (3, 3, 520, torch.bfloat16, True, True),
    (2, 1, 1024, torch.bfloat16, False, False)])
def test_k5_equals_its_plain_version_at_edge_shapes(card, T, B, H, dtype,
                                                    peep, masked):
    """atol 1e-5 in f32 (the reference's lstm pin), 2e-2 in bf16; the same
    bits in a second run, and under every plan pair that fits."""
    ops = _card_case(card, T, B, H, dtype, peep, masked, seed=T + B + H)
    got = lstm.fused_lstm_fwd(*ops)
    again = lstm.fused_lstm_fwd(*ops)
    want = lstm.lstm_fwd_reference(*ops)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert (g.float() - w.float()).abs().max().item() <= tol
    index = torch.cuda.current_device()
    for q, u in lstm.FWD_CANDIDATES:
        plan = lstm.FwdPlan(q, u, -(-H // u))
        lay = lstm._fwd_layout(index, H, B, dtype, q, u)
        if not lay.smem or plan.clusters > lay.max_clusters:
            continue
        for g, w in zip(lstm._fwd_launch(*ops, plan=plan), want):
            assert (g.float() - w.float()).abs().max().item() <= tol
