"""The port's updaters (deeplearning4j_tpu_torch/optimize/updaters.py)
against the JAX package's on the same float32 arrays made with numpy: each
of the nine rules over three steps, the six schedules, the five gradient
normalization modes, and ``MultiLayerUpdater``'s per-layer rules,
learning-rate multipliers and frozen layers. Tolerance 1e-6."""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.optimize import updaters as J
from deeplearning4j_tpu_torch.nn.layers import DenseLayer as TDense
from deeplearning4j_tpu_torch.optimize import updaters as P

TOL = 1e-6
RULES = ["Sgd", "NoOp", "Adam", "AdaMax", "Nadam", "AdaDelta", "Nesterovs",
         "AdaGrad", "RmsProp"]


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)


def test_registries_name_the_same_rules():
    assert sorted(P.UPDATER_BY_NAME) == sorted(J.UPDATER_BY_NAME)
    assert sorted(c.__name__ for c in P.UPDATER_BY_NAME.values()) == \
        sorted(RULES)


@pytest.mark.parametrize("rule", RULES)
def test_rule_matches_jax_over_three_steps(rule):
    r = np.random.default_rng(len(rule))
    p = r.normal(size=(6, 5)).astype(np.float32)
    lr = 0.05
    jr, tr = getattr(J, rule)(learning_rate=lr), \
        getattr(P, rule)(learning_rate=lr)
    js, ts = jr.init_one(jnp.asarray(p)), tr.init_one(torch.from_numpy(p))
    assert sorted(js) == sorted(ts)
    for step in range(3):
        g = r.normal(size=p.shape).astype(np.float32)
        jupd, js = jr.update_one(jnp.asarray(g), js, lr, step)
        tupd, ts = tr.update_one(torch.from_numpy(g), ts, lr, step)
        _close(tupd, jupd)
        for k in js:
            _close(ts[k], js[k])


SCHEDULES = [("ExponentialSchedule", dict(decay_rate=0.97)),
             ("InverseSchedule", dict(gamma=1e-2, power=0.75)),
             ("PolySchedule", dict(power=2.0, max_iter=1200)),
             ("SigmoidSchedule", dict(gamma=5e-3, step_size=900)),
             ("StepSchedule", dict(decay_rate=0.5, step_size=400)),
             ("MapSchedule", dict(schedule={"0": 0.3, "500": 0.1,
                                            "1000": 0.01}))]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, kw):
    js, ts = getattr(J, name)(**kw), getattr(P, name)(**kw)
    for step in (0, 1, 7, 399, 400, 999, 1000, 1500, 20000):
        np.testing.assert_allclose(ts(0.2, step), float(js(0.2, step)),
                                   rtol=TOL, err_msg=str(step))
    # a schedule drives the rule's lr, with the layer's multiplier
    jr = J.Sgd(learning_rate=0.2, schedule=js)
    tr = P.Sgd(learning_rate=0.2, schedule=ts)
    np.testing.assert_allclose(tr.lr(450, 0.5), float(jr.lr(450, 0.5)),
                               rtol=TOL)


def _layer_grads(seed):
    r = np.random.default_rng(seed)
    return [{"W": r.normal(size=(4, 3)).astype(np.float32) * 3,
             "b": r.normal(size=(3,)).astype(np.float32)},
            {},
            {"Wq": r.normal(size=(5, 5)).astype(np.float32) * 0.01}]


@pytest.mark.parametrize("mode", ["renormalizel2perlayer",
                                  "renormalizel2perparamtype",
                                  "clipelementwiseabsolutevalue",
                                  "clipl2perlayer", "clipl2perparamtype",
                                  None])
def test_normalize_gradients_matches_jax(mode):
    grads = _layer_grads(3)
    ref = J.normalize_gradients(
        tuple({k: jnp.asarray(v) for k, v in g.items()} for g in grads),
        mode, 1.5)
    ours = P.normalize_gradients(
        tuple({k: torch.from_numpy(v) for k, v in g.items()} for g in grads),
        mode, 1.5)
    assert [sorted(g) for g in ours] == [sorted(g) for g in ref]
    for og, rg in zip(ours, ref):
        for k in rg:
            _close(og[k], rg[k])


def test_unknown_normalization_mode_raises():
    with pytest.raises(ValueError, match="normalization"):
        P.normalize_gradients(({"W": torch.ones(2)},), "clipsomething")


def test_multilayer_updater_matches_jax():
    """Global Adam; a layer with its own learning rate and bias learning
    rate (multipliers on the global rule), a frozen layer, and a layer
    with its own rule; under clipl2perlayer normalization, two steps."""
    kws = [dict(n_out=3, learning_rate=0.01, bias_learning_rate=0.002),
           dict(n_out=3, frozen=True),
           dict(n_out=3, updater=("Nesterovs", 0.05))]

    def confs(mod, Dense):
        out = []
        for kw in kws:
            kw = dict(kw)
            if "updater" in kw:
                name, lr = kw["updater"]
                kw["updater"] = getattr(mod, name)(learning_rate=lr)
            out.append(Dense(**kw))
        return out

    r = np.random.default_rng(11)
    params = [{"W": r.normal(size=(4, 3)).astype(np.float32),
               "b": r.normal(size=(3,)).astype(np.float32)}
              for _ in kws]
    jmu = J.MultiLayerUpdater(confs(J, JDense), J.Adam(1e-3),
                              "clipl2perlayer", 2.0)
    names = ["a", "frozen", "own"]
    tmu = P.MultiLayerUpdater(dict(zip(names, confs(P, TDense))),
                              P.Adam(1e-3), "clipl2perlayer", 2.0)
    jp = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in params)
    tp = {n: {k: torch.from_numpy(v.copy()) for k, v in p.items()}
          for n, p in zip(names, params)}
    js, ts = jmu.init(jp), tmu.init(tp)
    for step in range(2):
        grads = [{k: r.normal(size=v.shape).astype(np.float32)
                  for k, v in p.items()} for p in params]
        jp, js = jmu.update(
            tuple({k: jnp.asarray(v) for k, v in g.items()} for g in grads),
            js, jp, step)
        tmu.update({n: {k: torch.from_numpy(v) for k, v in g.items()}
                    for n, g in zip(names, grads)}, ts, tp, step)
    for n, jpd, jsd in zip(names, jp, js):
        for k in jpd:
            _close(tp[n][k], jpd[k])
            for s in jsd[k]:
                _close(ts[n][k][s], jsd[k][s])
    # the frozen layer did not move; the others did
    for k in ("W", "b"):
        assert torch.equal(tp["frozen"][k], torch.from_numpy(params[1][k]))
        assert not torch.equal(tp["a"][k], torch.from_numpy(params[0][k]))


def test_updater_from_name():
    for name in J.UPDATER_BY_NAME:
        ours, ref = P.updater_from_name(name, 0.3), J.updater_from_name(name,
                                                                        0.3)
        assert type(ours).__name__ == type(ref).__name__
        assert ours.learning_rate == ref.learning_rate
    with pytest.raises(ValueError, match="available"):
        P.updater_from_name("nope")
