"""Loss functions.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``: the same registry and
names, every loss of that file with the same formula. Each loss takes the
output layer's *pre-activation* and its activation name, so the softmax
and sigmoid cross-entropies take the stable fused forms (``log_softmax``
of the pre-activation, logits for sigmoid). Every loss returns
per-example scores [batch]; a per-element or per-example mask multiplies
the elementwise loss before the sum over the feature (and time) axes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .activations import get_activation

_LOSSES = {}


def register_loss(*names):
    def deco(fn):
        for n in names:
            _LOSSES[n] = fn
        return fn
    return deco


def get_loss(name):
    key = str(name).lower()
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss {name!r}; available: {sorted(_LOSSES)}")
    return _LOSSES[key]


def loss_names():
    return sorted(_LOSSES)


def _reduce(elementwise, mask):
    """Sum elementwise loss over feature dims -> per-example score; apply
    the mask (broadcast over trailing dims) first."""
    if mask is not None:
        m = mask.to(elementwise.dtype)
        m = m.reshape(tuple(m.shape) + (1,) * (elementwise.dim() - m.dim()))
        elementwise = elementwise * m.expand_as(elementwise)
    return elementwise.sum(dim=tuple(range(1, elementwise.dim())))


def _activate(preout, activation):
    return get_activation(activation)(preout)


@register_loss("mse", "squared_loss")
def mse(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    # MSE divides by nOut (LossMSE = LossL2 / nOut), as the reference does
    return _reduce((out - labels) ** 2, mask) / labels.shape[-1]


@register_loss("l2")
def l2(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    return _reduce((out - labels) ** 2, mask)


@register_loss("mean_absolute_error", "mae")
def mae(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    return _reduce(torch.abs(out - labels), mask) / labels.shape[-1]


@register_loss("l1")
def l1(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    return _reduce(torch.abs(out - labels), mask)


@register_loss("mean_absolute_percentage_error", "mape")
def mape(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    eps = 1e-8
    return _reduce(100.0 * torch.abs((out - labels) / (labels + eps)),
                   mask) / labels.shape[-1]


@register_loss("mean_squared_logarithmic_error", "msle")
def msle(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    eps = 1e-8
    d = torch.log1p(out + eps) - torch.log1p(labels + eps)
    return _reduce(d ** 2, mask) / labels.shape[-1]


@register_loss("xent", "binary_crossentropy")
def xent(labels, preout, activation, mask=None):
    if str(activation).lower() == "sigmoid":
        # fused stable form from logits
        ew = (torch.clamp(preout, min=0) - preout * labels
              + torch.log1p(torch.exp(-torch.abs(preout))))
    else:
        out = torch.clamp(_activate(preout, activation), 1e-7, 1.0 - 1e-7)
        ew = -(labels * torch.log(out) + (1.0 - labels) * torch.log(1.0 - out))
    return _reduce(ew, mask)


@register_loss("mcxent", "negativeloglikelihood", "categorical_crossentropy")
def mcxent(labels, preout, activation, mask=None):
    if str(activation).lower() == "softmax":
        logp = F.log_softmax(preout, dim=-1)
    else:
        logp = torch.log(torch.clamp(_activate(preout, activation), 1e-7, 1.0))
    return _reduce(-labels * logp, mask)


@register_loss("sparse_mcxent")
def sparse_mcxent(labels, preout, activation, mask=None):
    """labels are integer class indices of shape [batch] (or [batch, time])."""
    logp = F.log_softmax(preout, dim=-1)
    picked = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        picked = picked * mask.to(picked.dtype)
    axes = tuple(range(1, picked.dim()))
    return -picked.sum(dim=axes) if axes else -picked


@register_loss("hinge")
def hinge(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    # labels in {-1, +1}
    return _reduce(torch.clamp(1.0 - labels * out, min=0.0), mask)


@register_loss("squared_hinge")
def squared_hinge(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    return _reduce(torch.clamp(1.0 - labels * out, min=0.0) ** 2, mask)


@register_loss("kl_divergence", "kld", "reconstruction_crossentropy")
def kl_divergence(labels, preout, activation, mask=None):
    out = torch.clamp(_activate(preout, activation), 1e-7, 1.0 - 1e-7)
    lab = torch.clamp(labels, 1e-7, 1.0)
    return _reduce(lab * (torch.log(lab) - torch.log(out)), mask)


@register_loss("poisson")
def poisson(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    return _reduce(out - labels * torch.log(torch.clamp(out, min=1e-7)), mask)


@register_loss("cosine_proximity")
def cosine_proximity(labels, preout, activation, mask=None):
    out = _activate(preout, activation)
    ln = torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
    on = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    cos = (labels * out).sum(dim=-1, keepdim=True) / torch.clamp(ln * on,
                                                                 min=1e-8)
    return _reduce(-cos, mask)
