"""K7 (the fused 1x1 conv + bias + relu) as redesigned for Hopper: the tile
plan the host hands the kernel, and what ``_launch`` hands it.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds every tile
instantiation against the plain version there, at GoogLeNet's 37 shapes
and at ragged ones); on the CPU the wrapper takes its plain version, whose
tests are in ``test_torch_conv.py``. What runs here is the arithmetic of
the plan: which blocks a call becomes and which channels each one adds.
"""
import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.zoo_extra import googlenet
from deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer
from deeplearning4j_tpu_torch.ops.kernels import conv as k7

SMS = 132                 # an H100 SXM's SMs


def _googlenet_1x1_shapes(B):
    """(M, C, F) of every 1x1 conv of a GoogLeNet forward at batch B, from
    the port's own shape inference (224x224x3, 1000 classes)."""
    conf = googlenet(n_classes=1000, height=224, width=224, channels=3,
                     device="cpu").conf
    itypes = dict(zip(conf.network_inputs, conf.input_types))
    out = []
    for name in conf.vertex_names:
        v = conf.vertices[name]
        it = [itypes[i] for i in conf.vertex_inputs[name]]
        itypes[name] = v.output_type(it)
        layer = getattr(v, "layer", None)
        if isinstance(layer, ConvolutionLayer) and \
                tuple(layer.kernel_size) == (1, 1):
            out.append((B * it[0].height * it[0].width, it[0].channels,
                        layer.n_out))
    return out


GOOGLENET = _googlenet_1x1_shapes(32)
RAGGED = [(1, 1, 1), (32, 128, 128), (1000, 100, 50), (1000, 37, 51),
          (65, 33, 129), (1568, 832, 384), (7, 2000, 3), (300, 64, 16)]


def test_the_port_infers_37_googlenet_1x1_convs():
    assert len(GOOGLENET) == 37
    assert {M for M, _, _ in GOOGLENET} == {100352, 25088, 6272, 1568}


@pytest.mark.parametrize("M, C, F", RAGGED + sorted(set(GOOGLENET)))
def test_plan_covers_every_output_and_every_channel_once(M, C, F):
    plan = k7.tile_plan(M, C, F)
    assert (plan.bm, plan.bn) in k7.TILES
    assert 1 <= plan.splits <= k7.MAX_SPLITS
    assert plan.k_per % k7.C_STEP == 0
    gx, gy, gz = plan.grid(M, F)
    assert gz == plan.splits
    hits = np.zeros((M, F), dtype=np.int64)
    for i in range(gx):
        for j in range(gy):
            hits[i * plan.bm:(i + 1) * plan.bm,
                 j * plan.bn:(j + 1) * plan.bn] += 1
    assert (hits == 1).all()
    # each channel falls in exactly one split's range (rank r takes
    # [r * k_per, min(C, (r + 1) * k_per)), as the kernel reads them), no
    # range is empty
    seen = np.zeros(C, dtype=np.int64)
    for r in range(plan.splits):
        begin, end = r * plan.k_per, min(C, (r + 1) * plan.k_per)
        assert 0 <= begin < end <= C
        seen[begin:end] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("M, C, F", sorted(set(GOOGLENET)))
def test_plan_fills_the_card_at_every_googlenet_shape(M, C, F):
    plan = k7.tile_plan(M, C, F, sms=SMS)
    assert plan.blocks(M, F) >= SMS, plan
    # a split only where no unsplit tile of the plan's width reaches the
    # blocks per SM the plan aims at
    if plan.splits > 1:
        lo = k7.BLOCKS_PER_SM[0] * SMS
        assert all(-(-M // bm) * -(-F // plan.bn) < lo
                   for bm, bn in k7.TILES if bn == plan.bn)


def test_plan_splits_c_for_the_7x7_convs():
    plans = {(C, F): k7.tile_plan(M, C, F) for M, C, F in GOOGLENET
             if M == 1568}
    assert all(p.splits > 1 for p in plans.values())
    assert max(p.splits for p in plans.values()) <= k7.MAX_SPLITS


@pytest.mark.parametrize("F", list(range(1, 49)))
def test_plan_never_takes_a_tile_wider_than_a_narrow_f_needs(F):
    need = min(bn for _, bn in k7.TILES if bn >= F)
    for M, C in ((25088, 192), (6272, 512), (1568, 832)):
        assert k7.tile_plan(M, C, F).bn <= need


@pytest.mark.parametrize("F, widths", [
    (16, {32}), (24, {32}), (32, {32}), (48, {32, 64}), (64, {32, 64}),
    (96, {32}), (112, {32, 64}), (128, {32, 64}), (144, {32}), (160, {32}),
    (192, {32, 64}), (256, {32, 64}), (384, {32, 64})])
def test_plan_picks_the_tile_that_pads_f_least(F, widths):
    """At GoogLeNet's 14x14 geometry (M 6272, C 512) the band alone lands
    on a tile width that pads F least, for every F the network uses."""
    assert k7.tile_plan(6272, 512, F).bn in widths


def test_plan_keeps_a_small_call_whole_and_refuses_an_empty_one():
    # one step of C: no split; every tile gives one block, the first wins
    assert tuple(k7.tile_plan(1, 1, 1)) == (64, 32, 1, 32)
    # 32 x 128 x 128 (the reference's parity shape): far below the band
    # whatever the plan, so the most blocks: four ranges of one C step
    assert tuple(k7.tile_plan(32, 128, 128)) == (64, 32, 4, 32)
    assert tuple(k7.tile_plan(1000, 100, 50)) == (64, 32, 4, 32)
    with pytest.raises(ValueError, match="1 <= M, C, F"):
        k7.tile_plan(0, 4, 4)


def test_plan_is_worked_out_once_a_shape():
    """A served network asks for the same shapes on every forward: the
    second ask costs a cache lookup, not the search."""
    k7.tile_plan.cache_clear()
    first = k7.tile_plan(6272, 512, 64, 132)
    assert k7.tile_plan(6272, 512, 64, 132) is first
    info = k7.tile_plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)


def _admissible(M, C, F):
    """Every plan the kernel takes for this call: a compiled tile and C cut
    into 1-8 non-empty ranges of a multiple of 32 channels."""
    steps = -(-C // k7.C_STEP)
    for bm, bn in k7.TILES:
        for s in range(1, min(k7.MAX_SPLITS, steps) + 1):
            k_per = -(-steps // s) * k7.C_STEP
            if -(-C // k_per) == s:
                yield k7.TilePlan(bm, bn, s, k_per)


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
def test_plan_lands_in_the_target_whenever_a_plan_can(sms):
    """If any admissible plan puts 2.5-4.5 blocks on each SM, the chosen
    one does."""
    lo, hi = k7.BLOCKS_PER_SM
    for M, C, F in sorted(set(GOOGLENET)) + RAGGED:
        plan = k7.tile_plan(M, C, F, sms=sms)
        assert plan in set(_admissible(M, C, F))
        reachable = any(lo <= p.blocks(M, F) / sms <= hi
                        for p in _admissible(M, C, F))
        if reachable:
            assert lo <= plan.blocks(M, F) / sms <= hi, (M, C, F, plan)


def test_the_sweeps_copy_of_the_rule_is_tile_plans():
    """``k7_study.py sweep`` scores ``tile_plan``'s rule against variants
    of it from one copy: asked for no variant, the copy picks
    ``tile_plan``'s plan at every shape GoogLeNet serves at B 1, 8 and 32,
    and the plans it times are the ones the kernel takes."""
    import k7_study
    shapes = sorted({s for B in (1, 8) for s in _googlenet_1x1_shapes(B)}
                    | set(GOOGLENET))
    assert len(shapes) == 90
    for M, C, F in shapes:
        assert k7_study.rule_pick(M, C, F, SMS) == k7.tile_plan(M, C, F, SMS)
        assert set(k7_study.admissible(M, C, F)) == set(_admissible(M, C, F))


def test_launch_hands_the_kernel_its_plan_and_an_aligned_x(monkeypatch):
    seen = []

    class FakeStream:
        cuda_stream = 0

    def fake_kernel(*args):
        seen.append(args)
        return 0

    class Null:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(k7, "load_symbol", lambda *a: fake_kernel)
    monkeypatch.setattr(k7, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: FakeStream())
    M, C, F = 1568, 832, 48
    base = torch.zeros(M * C + 1)
    x = base[1:].view(M, C)                        # 4 bytes off
    assert x.data_ptr() % 16 == 4
    w, b = torch.zeros(C, F), torch.zeros(F)
    out = k7._launch(x, w, b)
    assert out.shape == (M, F)
    args = seen[0]
    assert args[0] % 16 == 0 and args[0] != x.data_ptr()
    assert args[1] == w.data_ptr() and args[3] == out.data_ptr()
    assert args[4:8] == (M, C, F, 0)
    assert args[8:12] == tuple(k7.tile_plan(M, C, F, SMS))


def test_launch_raises_on_a_cuda_error(monkeypatch):
    class FakeStream:
        cuda_stream = 0

    class Null:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(k7, "load_symbol", lambda *a: (lambda *args: 1))
    monkeypatch.setattr(k7, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: FakeStream())
    x, w, b = torch.zeros(8, 4), torch.zeros(4, 3), torch.zeros(3)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        k7._launch(x, w, b)


def test_shared_memory_entry_is_loaded_from_k7s_library(monkeypatch):
    calls = []

    def fake_load(symbol, build, argtypes):
        calls.append((symbol, build, len(argtypes)))
        return lambda bm, bn, bf: bm * 1000 + bn * 10 + bf

    monkeypatch.setattr(k7, "load_symbol", fake_load)
    assert k7.shared_memory_bytes(128, 64, torch.bfloat16) == 128641
    assert calls == [("dl4j_conv1x1_bias_relu_smem", k7.build, 3)]
