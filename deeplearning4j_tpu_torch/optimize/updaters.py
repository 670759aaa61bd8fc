"""Updaters: parameter-update rules, learning-rate schedules and gradient
normalization.

Counterpart of ``deeplearning4j_tpu/optimize/updaters.py``: the nine rules
(Sgd, Adam, AdaMax, Nadam, AdaDelta, Nesterovs, AdaGrad, RmsProp, NoOp),
the six schedules, ``normalize_gradients`` and ``MultiLayerUpdater`` with
its per-layer rule, learning-rate multipliers and ``frozen`` layers.

Every rule is the reference's formula on tensors: ``init_one(p)`` makes the
state and ``update_one(g, s, lr, step)`` returns ``(update, new_state)``
with ``new_params = params - update``. State is kept in the parameter's
dtype, as the reference keeps it (so Adam's ``m`` and ``v`` are bf16 in a
bf16 net), which is why ``torch.optim`` is not used: it keeps other state
types and orders the arithmetic otherwise. ``MultiLayerUpdater.update``
applies the result in place under ``torch.no_grad()``.

The iteration is a tensor, as the reference traces ``it`` as an int32
scalar in one program for the per-step and the window path
(``deeplearning4j_tpu/optimize/solver.py:33-74, 110-166``): the solver
passes a 0-dim integer tensor on the network's device, and every term that
depends on it (a schedule's learning rate, Adam's ``beta ** t``) is a
float64 0-dim tensor computed on that device, never a Python number. So a
captured training step (``optimize/step_graph.py``) reads the iteration
of each replay, not the one of its capture, and a window is K single steps
by construction. A float64 term meets a float32 (or bf16) tensor as a
scalar: it is rounded to the tensor's type, as the reference's weakly
typed float64 scalars are under x64. A Python int is accepted too (it
becomes a CPU tensor), which is how the parity tests call a rule alone.
The rules and schedules are registered for JSON serde
(``nn/conf/serde.py``) under the reference's names.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import torch

from ..nn.conf.serde import register


def step_tensor(step) -> torch.Tensor:
    """The iteration as a float64 0-dim tensor, on the device of ``step``
    when it is a tensor (on the CPU for a Python int)."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float64)
    return torch.tensor(float(step), dtype=torch.float64)


# --------------------------------------------------------------------------
# LR schedules
# --------------------------------------------------------------------------

@register
@dataclass(frozen=True)
class ExponentialSchedule:
    decay_rate: float = 0.99

    def __call__(self, base_lr, step):
        return base_lr * self.decay_rate ** step_tensor(step)


@register
@dataclass(frozen=True)
class InverseSchedule:
    gamma: float = 1e-3
    power: float = 1.0

    def __call__(self, base_lr, step):
        return base_lr / (1.0 + self.gamma * step_tensor(step)) ** self.power


@register
@dataclass(frozen=True)
class PolySchedule:
    power: float = 1.0
    max_iter: int = 10000

    def __call__(self, base_lr, step):
        frac = torch.clamp(step_tensor(step) / self.max_iter, max=1.0)
        return base_lr * (1.0 - frac) ** self.power


@register
@dataclass(frozen=True)
class SigmoidSchedule:
    gamma: float = 1e-2
    step_size: int = 1000

    def __call__(self, base_lr, step):
        return base_lr / (1.0 + torch.exp(
            -self.gamma * (step_tensor(step) - self.step_size)))


@register
@dataclass(frozen=True)
class StepSchedule:
    decay_rate: float = 0.1
    step_size: int = 1000

    def __call__(self, base_lr, step):
        return base_lr * self.decay_rate ** torch.floor(
            step_tensor(step) / self.step_size)


@register
@dataclass(frozen=True)
class MapSchedule:
    """Explicit {iteration: lr} map (reference ``learningRateSchedule``)."""
    schedule: Dict[str, float] = field(default_factory=dict)

    def __call__(self, base_lr, step):
        step = step_tensor(step)
        lr = torch.full_like(step, base_lr)
        for k in sorted(self.schedule, key=lambda s: int(s)):
            lr = torch.where(step >= int(k),
                             torch.full_like(step, self.schedule[k]), lr)
        return lr


# --------------------------------------------------------------------------
# Update rules
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class UpdaterConf:
    learning_rate: float = 0.1
    schedule: Optional[Any] = None

    def lr(self, step, lr_mult=1.0):
        base = self.learning_rate * lr_mult
        return self.schedule(base, step) if self.schedule is not None else base

    def step_terms(self, step) -> dict:
        """The rule's terms that depend on the iteration alone (float64
        0-dim tensors), computed once a step for all the parameters the
        rule updates."""
        return {}

    def init_one(self, p):
        return {}

    def update_one(self, g, s, lr, step, terms=None):
        raise NotImplementedError


def _bias_terms(beta1, beta2, step) -> dict:
    """1 - beta1 ** t and 1 - beta2 ** t at t = step + 1."""
    t = step_tensor(step) + 1
    return {"c1": 1 - beta1 ** t, "c2": 1 - beta2 ** t}


@register
@dataclass(frozen=True)
class Sgd(UpdaterConf):
    def update_one(self, g, s, lr, step, terms=None):
        return lr * g, s


@register
@dataclass(frozen=True)
class NoOp(UpdaterConf):
    """Updater.NONE: raw gradient applied unscaled."""
    def update_one(self, g, s, lr, step, terms=None):
        return g, s


@register
@dataclass(frozen=True)
class Adam(UpdaterConf):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def step_terms(self, step):
        return _bias_terms(self.beta1, self.beta2, step)

    def update_one(self, g, s, lr, step, terms=None):
        c = terms or self.step_terms(step)
        m = self.beta1 * s["m"] + (1 - self.beta1) * g
        v = self.beta2 * s["v"] + (1 - self.beta2) * g * g
        mhat = m / c["c1"]
        vhat = v / c["c2"]
        return lr * mhat / (torch.sqrt(vhat) + self.epsilon), {"m": m, "v": v}


@register
@dataclass(frozen=True)
class AdaMax(UpdaterConf):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def step_terms(self, step):
        return _bias_terms(self.beta1, self.beta2, step)

    def update_one(self, g, s, lr, step, terms=None):
        c = terms or self.step_terms(step)
        m = self.beta1 * s["m"] + (1 - self.beta1) * g
        u = torch.maximum(self.beta2 * s["u"], torch.abs(g))
        return (lr / c["c1"] * m / (u + self.epsilon), {"m": m, "u": u})


@register
@dataclass(frozen=True)
class Nadam(UpdaterConf):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_one(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def step_terms(self, step):
        return _bias_terms(self.beta1, self.beta2, step)

    def update_one(self, g, s, lr, step, terms=None):
        c = terms or self.step_terms(step)
        m = self.beta1 * s["m"] + (1 - self.beta1) * g
        v = self.beta2 * s["v"] + (1 - self.beta2) * g * g
        mhat = m / c["c1"]
        vhat = v / c["c2"]
        nudge = (1 - self.beta1) * g / c["c1"]
        return (lr * (self.beta1 * mhat + nudge)
                / (torch.sqrt(vhat) + self.epsilon), {"m": m, "v": v})


@register
@dataclass(frozen=True)
class AdaDelta(UpdaterConf):
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_one(self, p):
        return {"msg": torch.zeros_like(p), "msdx": torch.zeros_like(p)}

    def update_one(self, g, s, lr, step, terms=None):
        # lr is unused (the reference's AdaDelta has no learning rate)
        msg = self.rho * s["msg"] + (1 - self.rho) * g * g
        upd = (g * torch.sqrt(s["msdx"] + self.epsilon)
               / torch.sqrt(msg + self.epsilon))
        msdx = self.rho * s["msdx"] + (1 - self.rho) * upd * upd
        return upd, {"msg": msg, "msdx": msdx}


@register
@dataclass(frozen=True)
class Nesterovs(UpdaterConf):
    momentum: float = 0.9

    def init_one(self, p):
        return {"v": torch.zeros_like(p)}

    def update_one(self, g, s, lr, step, terms=None):
        # v' = mu*v - lr*g; the applied update is mu*v - (1+mu)*v'
        v_prev = s["v"]
        v = self.momentum * v_prev - lr * g
        return self.momentum * v_prev - (1 + self.momentum) * v, {"v": v}


@register
@dataclass(frozen=True)
class AdaGrad(UpdaterConf):
    epsilon: float = 1e-6

    def init_one(self, p):
        return {"h": torch.zeros_like(p)}

    def update_one(self, g, s, lr, step, terms=None):
        h = s["h"] + g * g
        return lr * g / (torch.sqrt(h) + self.epsilon), {"h": h}


@register
@dataclass(frozen=True)
class RmsProp(UpdaterConf):
    decay: float = 0.95
    epsilon: float = 1e-8

    def init_one(self, p):
        return {"h": torch.zeros_like(p)}

    def update_one(self, g, s, lr, step, terms=None):
        h = self.decay * s["h"] + (1 - self.decay) * g * g
        return lr * g / torch.sqrt(h + self.epsilon), {"h": h}


UPDATER_BY_NAME = {
    "sgd": Sgd, "adam": Adam, "adamax": AdaMax, "adadelta": AdaDelta,
    "nesterovs": Nesterovs, "nadam": Nadam, "adagrad": AdaGrad,
    "rmsprop": RmsProp, "none": NoOp,
}


def updater_from_name(name, lr=0.1):
    key = str(name).lower()
    if key not in UPDATER_BY_NAME:
        raise ValueError(f"Unknown updater {name!r}; available: "
                         f"{sorted(UPDATER_BY_NAME)}")
    cls = UPDATER_BY_NAME[key]
    try:
        return cls(learning_rate=lr)
    except TypeError:
        return cls()


# --------------------------------------------------------------------------
# Gradient normalization
# --------------------------------------------------------------------------

def _l2(tensors) -> torch.Tensor:
    return torch.sqrt(sum((v * v).sum() for v in tensors) + 1e-12)


def normalize_gradients(grads_per_layer, mode: Optional[str],
                        threshold: float = 1.0):
    """grads_per_layer: a sequence of per-layer dicts {param_name: grad};
    returns a new tuple of dicts."""
    if mode is None or mode == "none":
        return grads_per_layer
    mode = str(mode).lower()
    if mode == "renormalizel2perlayer":
        return tuple({k: v / (_l2(g.values()) if g else 1.0)
                      for k, v in g.items()} for g in grads_per_layer)
    if mode == "renormalizel2perparamtype":
        return tuple({k: v / _l2([v]) for k, v in g.items()}
                     for g in grads_per_layer)
    if mode == "clipelementwiseabsolutevalue":
        return tuple({k: torch.clamp(v, -threshold, threshold)
                      for k, v in g.items()} for g in grads_per_layer)
    if mode == "clipl2perlayer":
        out = []
        for g in grads_per_layer:
            if not g:
                out.append(g)
                continue
            scale = torch.clamp(threshold / _l2(g.values()), max=1.0)
            out.append({k: v * scale for k, v in g.items()})
        return tuple(out)
    if mode == "clipl2perparamtype":
        return tuple({k: v * torch.clamp(threshold / _l2([v]), max=1.0)
                      for k, v in g.items()} for g in grads_per_layer)
    raise ValueError(f"Unknown gradient normalization mode {mode!r}")


# --------------------------------------------------------------------------
# Multi-layer updater: each layer's rule on its parameters
# --------------------------------------------------------------------------

class MultiLayerUpdater:
    """Applies each layer's rule to its parameters. ``layer_confs`` maps a
    vertex name to its layer (None for a vertex without one); parameters,
    gradients and state are dicts by vertex name, then parameter name (and
    state name)."""

    def __init__(self, layer_confs: Mapping[str, Any], global_updater,
                 grad_norm=None, grad_norm_threshold=1.0):
        self.layer_confs = dict(layer_confs)
        self.global_updater = global_updater
        self.grad_norm = grad_norm
        self.grad_norm_threshold = grad_norm_threshold

    def rule_for(self, layer_conf):
        own = getattr(layer_conf, "updater", None)
        return own if own is not None else self.global_updater

    def _lr_mult(self, layer_conf, pname):
        bias_lr = getattr(layer_conf, "bias_learning_rate", None)
        if pname not in getattr(layer_conf, "weight_param_names", ("W",)) \
                and bias_lr is not None:
            base = self.rule_for(layer_conf).learning_rate
            return bias_lr / base if base else 1.0
        own_lr = getattr(layer_conf, "learning_rate", None)
        if own_lr is not None:
            base = self.rule_for(layer_conf).learning_rate
            return own_lr / base if base else 1.0
        return 1.0

    def init(self, params) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
        return {name: {k: self.rule_for(self.layer_confs[name]).init_one(
                           v.detach())
                       for k, v in p.items()}
                for name, p in params.items()}

    @torch.no_grad()
    def update(self, grads, opt_state, params, step) -> None:
        """One step in place: ``params`` and ``opt_state`` are updated from
        ``grads`` (a frozen layer's entry may be missing or empty) at
        iteration ``step``, a 0-dim integer tensor (see the module
        docstring). Each rule's iteration terms and each (rule, multiplier)
        learning rate are computed once a call."""
        names = list(params)
        normed = normalize_gradients(tuple(grads.get(n, {}) for n in names),
                                     self.grad_norm, self.grad_norm_threshold)
        step = step_tensor(step)
        terms, lrs = {}, {}
        for name, g in zip(names, normed):
            conf = self.layer_confs[name]
            if getattr(conf, "frozen", False):
                continue    # reference FrozenLayer: no updates
            rule = self.rule_for(conf)
            if id(rule) not in terms:
                terms[id(rule)] = rule.step_terms(step)
            for k, p in params[name].items():
                s = opt_state[name][k]
                key = (id(rule), self._lr_mult(conf, k))
                if key not in lrs:
                    lrs[key] = rule.lr(step, key[1])
                upd, new_s = rule.update_one(g[k], s, lrs[key], step,
                                             terms[id(rule)])
                p.sub_(upd.to(p.dtype))
                for sk, sv in new_s.items():
                    s[sk].copy_(sv)
