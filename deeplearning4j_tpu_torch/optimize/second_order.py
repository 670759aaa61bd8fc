"""Second-order and line-search solvers: LineGradientDescent,
ConjugateGradient and LBFGS with a backtracking line search.

Counterpart of ``deeplearning4j_tpu/optimize/second_order.py``:
``BackTrackLineSearch`` (``:23-55``), the loss and gradient of the flat
parameter vector (``_FlatProblem``, ``:58-121``), one outer iteration a
minibatch (``SecondOrderOptimizer.step``, ``:124-177``), the three
directions (``:180-242``) and ``make_optimizer``. The solver reaches
them through the configuration's ``optimization_algorithm`` and
``max_num_line_search_iterations``.

The flat vector is a float64 tensor on the network's device (the
reference's is a float64 numpy array), and so are the direction and the
L-BFGS history; the loss and gradient run in the network's dtype at the
parameters the vector holds (``set_params_flat``). As in the reference,
the line search reads each trial's score on the host, so a second-order
fit is never captured into a CUDA graph nor windowed. The new layer state
of the one pre-step forward (a BatchNormalization's running statistics)
is committed with an accepted step, as the reference keeps it; a rejected
step changes nothing. Dropout draws from a generator reseeded by the
outer iteration, as the reference folds it into its key.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Optional, Tuple

import torch

from ..nn.tape import collect_state, commit_state


class BackTrackLineSearch:
    """Armijo backtracking: halve the step (``rho``) until the score falls
    by at least ``c1`` x step x slope, at most ``max_iterations`` times."""

    def __init__(self, c1: float = 1e-4, rho: float = 0.5,
                 max_iterations: int = 5, min_step: float = 1e-12):
        self.c1 = c1
        self.rho = rho
        self.max_iterations = max_iterations
        self.min_step = min_step

    def search(self, f: Callable[[torch.Tensor], float], x0: torch.Tensor,
               direction: torch.Tensor, f0: float, g0: torch.Tensor,
               initial_step: float = 1.0) -> Tuple[float, float]:
        """(step, score at the step); (0, f0) when no step decreases the
        score enough or ``direction`` is not a descent direction (the
        caller keeps the old parameters)."""
        slope = float(g0 @ direction)
        if slope >= 0:
            return 0.0, f0
        step = initial_step
        for _ in range(self.max_iterations):
            fx = float(f(x0 + step * direction))
            if fx == fx and abs(fx) != float("inf") and \
                    fx <= f0 + self.c1 * step * slope:
                return step, fx
            step *= self.rho
            if step < self.min_step:
                break
        return 0.0, f0


class _FlatProblem:
    """The loss and gradient of the flat parameter vector on one batch."""

    def __init__(self, net):
        self.net = net
        self._gen = torch.Generator(device=net.device)
        self._it = 0

    def flat0(self) -> torch.Tensor:
        return self.net.params_flat().to(torch.float64)

    def _reseed(self):
        self._gen.manual_seed(((self.net.conf.seed + 7919) << 32) + self._it)
        return self._gen

    def value_and_grad(self, flat, x, y, lmask=None, fmask=None):
        """(score, gradient as a flat float64 vector, the new layer
        state) at ``flat``."""
        net = self.net
        net.set_params_flat(flat)
        params = list(net._ordered_params())
        with collect_state({}) as new_state:
            loss = net.loss_fn(x, y, train=True, gen=self._reseed(),
                               labels_mask=lmask, features_mask=fmask)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        g = torch.cat([(torch.zeros_like(p) if gp is None else gp)
                       .reshape(-1) for p, gp in zip(params, grads)])
        return float(loss.detach()), g.to(torch.float64), new_state

    def loss_only(self, x, y, lmask=None, fmask=None):
        """score(flat) on the batch; nothing is kept."""
        @torch.no_grad()
        def f(flat):
            self.net.set_params_flat(flat)
            with collect_state({}):
                return float(self.net.loss_fn(
                    x, y, train=True, gen=self._reseed(), labels_mask=lmask,
                    features_mask=fmask))
        return f

    def commit(self, flat, new_state=None):
        self.net.set_params_flat(flat)
        if new_state is not None:
            commit_state(new_state)


class SecondOrderOptimizer:
    """One outer iteration a minibatch: a direction, a line search along
    it, the accepted step. Subclasses give ``direction``."""

    name = "base"

    def __init__(self, net, max_line_search_iterations: int = 5):
        self.problem = _FlatProblem(net)
        self.line_search = BackTrackLineSearch(
            max_iterations=max_line_search_iterations)
        self._prev_g: Optional[torch.Tensor] = None
        self._prev_d: Optional[torch.Tensor] = None

    def direction(self, g: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, x, y, lmask=None, fmask=None) -> float:
        """One outer iteration on a batch; returns the score after it."""
        flat = self.problem.flat0()
        f0, g, new_state = self.problem.value_and_grad(flat, x, y, lmask,
                                                       fmask)
        d = self.direction(g)
        dn = float(torch.linalg.vector_norm(d))
        if dn > 1e3:                       # keep the line search in range
            d = d * (1e3 / dn)
        step, fx = self.line_search.search(
            self.problem.loss_only(x, y, lmask, fmask), flat, d, f0, g)
        self.problem._it += 1
        if step > 0:
            new_flat = flat + step * d
            self._record(flat, g, new_flat, step)
            self.problem.commit(new_flat, new_state)
            return fx
        self._record(flat, g, flat, 0.0)
        self.problem.commit(flat)          # a rejected step is a no-op
        return f0

    def _record(self, flat, g, new_flat, step):
        self._prev_g = g
        self._prev_d = None if step == 0 else (new_flat - flat) / step


class LineGradientDescent(SecondOrderOptimizer):
    """Steepest descent with the line search."""

    name = "line_gradient_descent"

    def direction(self, g):
        return -g


class ConjugateGradient(SecondOrderOptimizer):
    """Nonlinear conjugate gradient, Polak-Ribiere beta with restart at
    beta < 0."""

    name = "conjugate_gradient"

    def direction(self, g):
        if self._prev_g is None or self._prev_d is None:
            return -g
        denom = float(self._prev_g @ self._prev_g)
        beta = max(0.0, float(g @ (g - self._prev_g)) / max(denom, 1e-12))
        return -g + beta * self._prev_d


class LBFGS(SecondOrderOptimizer):
    """Limited-memory BFGS by the two-loop recursion over the last ``m``
    (s, y) pairs; a pair enters only if s·y > 1e-10 (the curvature
    condition)."""

    name = "lbfgs"

    def __init__(self, net, max_line_search_iterations: int = 5, m: int = 4):
        super().__init__(net, max_line_search_iterations)
        self.m = m
        self._hist: Deque[Tuple[torch.Tensor, torch.Tensor]] = deque(
            maxlen=m)
        self._last_flat: Optional[torch.Tensor] = None
        self._last_g: Optional[torch.Tensor] = None

    def direction(self, g):
        q = g.clone()
        alphas = []
        for s, yv in reversed(self._hist):
            rho = 1.0 / max(float(yv @ s), 1e-12)
            a = rho * float(s @ q)
            alphas.append((a, rho, s, yv))
            q -= a * yv
        if self._hist:
            s, yv = self._hist[-1]
            q *= float(s @ yv) / max(float(yv @ yv), 1e-12)
        for a, rho, s, yv in reversed(alphas):
            q += (a - rho * float(yv @ q)) * s
        return -q

    def _record(self, flat, g, new_flat, step):
        # the pair from the previous iteration's point to this one
        if self._last_flat is not None:
            s = flat - self._last_flat
            yv = g - self._last_g
            if float(s @ yv) > 1e-10:
                self._hist.append((s, yv))
        self._last_flat = flat.clone()
        self._last_g = g.clone()
        super()._record(flat, g, new_flat, step)


_ALGOS = {
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


def make_optimizer(name: str, net, max_line_search_iterations: int = 5):
    """The solver named ``name`` (one of ``_ALGOS``) for ``net``."""
    try:
        cls = _ALGOS[name.lower()]
    except KeyError:
        raise ValueError(f"Unknown optimization algorithm {name!r}; "
                         f"available: sgd, {', '.join(sorted(_ALGOS))}")
    return cls(net, max_line_search_iterations)
