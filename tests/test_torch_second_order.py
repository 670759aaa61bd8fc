"""The port's second-order solvers (``optimize/second_order.py``) against
the JAX package's.

``BackTrackLineSearch`` on the reference's quadratic (the same step and
score, and an ascent direction refused); each of LineGradientDescent,
ConjugateGradient and LBFGS driving ``fit`` (``optimization_algorithm``)
on a small MLP in float64 from the same weights: the score after each
outer iteration and the parameters after K of them at 1e-9; the
reference's unknown-algorithm raise; LBFGS's curvature guard; and a
second-order fit runs per step (``steps_per_dispatch`` is ignored, as the
reference ignores it)."""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import MultiLayerNetwork as JMLN
from deeplearning4j_tpu import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.optimize import second_order as jso
from deeplearning4j_tpu.optimize.updaters import Sgd as JSgd
from deeplearning4j_tpu_torch.interop.jax_params import load_jax_params
from deeplearning4j_tpu_torch.nn import layers as tl
from deeplearning4j_tpu_torch.nn.conf.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import second_order as tso
from deeplearning4j_tpu_torch.optimize.updaters import Sgd

ALGOS = ["line_gradient_descent", "conjugate_gradient", "lbfgs"]


def test_backtrack_line_search_quadratic():
    f = lambda x: float(((x - 1.0) ** 2).sum())
    x0 = np.zeros(3)
    g0 = 2 * (x0 - 1.0)
    want = jso.BackTrackLineSearch(max_iterations=20).search(
        lambda v: float(np.sum((v - 1.0) ** 2)), x0, -g0, f(x0), g0,
        initial_step=1.0)
    ls = tso.BackTrackLineSearch(max_iterations=20)
    t0, tg = torch.zeros(3, dtype=torch.float64), torch.as_tensor(g0)
    step, fx = ls.search(f, t0, -tg, f(t0), tg, initial_step=1.0)
    assert step > 0 and fx < f(t0)
    assert (step, fx) == want
    # an ascent direction is refused
    assert ls.search(f, t0, tg, f(t0), tg) == (0.0, f(t0))


def _nets(algo, seed=4):
    def conf(C, L, S):
        return (C(seed=seed, updater=S(0.1), dtype="float64",
                  optimization_algorithm=algo,
                  max_num_line_search_iterations=8)
                .list(L.DenseLayer(n_in=4, n_out=12, activation="tanh"),
                      L.OutputLayer(n_out=3, activation="softmax",
                                    loss="mcxent")).build())
    jnet = JMLN(conf(JConf, jl, JSgd)).init()
    pnet = MultiLayerNetwork(conf(NeuralNetConfiguration, tl, Sgd),
                             device="cpu").init()
    load_jax_params(pnet, [{k: np.asarray(v) for k, v in p.items()}
                           for p in jnet.params])
    return jnet, pnet


def _data(n=120, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    yi = (x[:, 0] + x[:, 1] > 0).astype(int) + (x[:, 2] > 0.5).astype(int)
    return x, np.eye(3)[yi]


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration, loss):
        self.scores.append(float(loss))


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_jax_in_float64(algo):
    jnet, pnet = _nets(algo)
    x, y = _data()
    js, ts = _Scores(), _Scores()
    jnet.set_listeners(js)
    pnet.set_listeners(ts)
    s0 = pnet.score(x, y)
    assert abs(s0 - jnet.score(x, y)) <= 1e-12
    jnet.fit(x, y, epochs=8, batch_size=120)
    pnet.fit(x, y, epochs=8, batch_size=120)
    assert pnet.iteration_count == jnet.iteration_count == 8
    np.testing.assert_allclose(ts.scores, js.scores, rtol=0, atol=1e-9)
    np.testing.assert_allclose(pnet.params_flat().numpy(),
                               np.asarray(jnet.params_flat()), rtol=0,
                               atol=1e-9)
    assert pnet.score(x, y) < s0


def test_unknown_algorithm_raises():
    _, pnet = _nets("sgd")
    with pytest.raises(ValueError, match="available"):
        tso.make_optimizer("newton", pnet)
    _, pnet = _nets("newton")
    x, y = _data(8)
    with pytest.raises(ValueError, match="available"):
        pnet.fit(x, y, batch_size=8)


def test_lbfgs_history_curvature_guard():
    jnet, pnet = _nets("lbfgs")
    x, y = _data(40)
    opt, jopt = tso.LBFGS(pnet), jso.LBFGS(jnet)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    for _ in range(6):
        score = opt.step(tx, ty)
        assert abs(score - jopt.step(x, y)) <= 1e-9
    assert len(opt._hist) == len(jopt._hist) >= 1
    for s, yv in opt._hist:
        assert float(s @ yv) > 1e-10


def test_second_order_fit_runs_per_step():
    _, pnet = _nets("conjugate_gradient")
    x, y = _data(40)
    pnet.fit(x, y, batch_size=10, steps_per_dispatch=4)
    assert pnet.iteration_count == 4
    assert pnet._solver_inst.graph_stats()["captures"] == 0
    with pytest.raises(ValueError, match="tBPTT"):
        pnet.conf.backprop_type = "tbptt"
        pnet._solver_inst._second_order_solver(True)
