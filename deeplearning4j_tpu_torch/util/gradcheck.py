"""Numerical against analytic gradients: the port's own check of its
backward.

Counterpart of ``deeplearning4j_tpu/util/gradcheck.py``: ``check_gradients``
(``:163-197``) for a ``MultiLayerNetwork`` or a ``ComputationGraph``, with
labels and features masks, and ``check_pretrain_gradients`` (``:115-160``)
for a layer's unsupervised loss. The network must be float64, as the
reference requires. For each checked parameter the central difference
(L(p + eps) - L(p - eps)) / 2 eps is compared with ``torch.autograd``'s
gradient at p; a parameter fails when its relative error
|a - n| / (|a| + |n|) exceeds ``max_rel_error`` and its absolute error
exceeds ``min_abs_error``. ``subset`` checks that many parameters, drawn
as the reference draws them (``np.random.default_rng(seed).choice``).

The 2N perturbed losses are evaluated eagerly in float64 under
``torch.no_grad``, each with one entry of one parameter moved in place and
put back, and read to the host a chunk at a time (one read per chunk, not
per evaluation). No program is compiled or fused, as the reference's
check runs unjitted. A layer on the card whose kernel takes float32 or
bf16 only (the LSTM's) takes its plain path in float64, so on the card
this checks the plain backward around the kernels, not the kernels.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

_CHUNK = 512


def _entries(params: List[torch.Tensor]):
    """(parameter, flat index) for each entry of ``params``, in order."""
    return [(p, j) for p in params for j in range(p.numel())]


@torch.no_grad()
def _perturbed_losses(loss, params: List[torch.Tensor], idxs: np.ndarray,
                      epsilon: float) -> np.ndarray:
    """``loss()`` with entry i moved by +eps, then by -eps, for each i in
    ``idxs``: [2K] values, the +eps ones first."""
    entries = _entries(params)
    out = []
    for sign in (epsilon, -epsilon):
        chunk = []
        for i in idxs:
            p, j = entries[int(i)]
            flat = p.view(-1)
            was = flat[j].clone()
            flat[j] += sign
            chunk.append(loss())
            flat[j] = was
            if len(chunk) == _CHUNK:
                out.append(torch.stack(chunk).cpu())
                chunk = []
        if chunk:
            out.append(torch.stack(chunk).cpu())
    return torch.cat(out).numpy() if out else np.zeros((0,))


def _check(loss, params: List[torch.Tensor], *, epsilon: float,
           max_rel_error: float, min_abs_error: float,
           subset: Optional[int], seed: int, print_results: bool) -> bool:
    """Central differences of ``loss()`` over ``params`` against its
    autograd gradient."""
    grads = torch.autograd.grad(loss(), params, allow_unused=True)
    analytic = torch.cat([(torch.zeros_like(p) if g is None else g)
                          .reshape(-1) for p, g in zip(params, grads)]
                         ).detach().cpu().numpy()
    n = analytic.shape[0]
    idxs = np.arange(n)
    if subset is not None and subset < n:
        idxs = np.random.default_rng(seed).choice(n, size=subset,
                                                  replace=False)
    k = len(idxs)
    vals = _perturbed_losses(loss, params, idxs, epsilon)
    numeric_all = (vals[:k] - vals[k:]) / (2 * epsilon)
    max_rel_seen, fails = 0.0, 0
    for j, i in enumerate(idxs):
        numeric, a = float(numeric_all[j]), float(analytic[i])
        denom = abs(a) + abs(numeric)
        rel = abs(a - numeric) / denom if denom > 0 else 0.0
        if rel > max_rel_error and abs(a - numeric) > min_abs_error:
            fails += 1
            if print_results:
                print(f"param {i}: analytic={a:.8g} numeric={numeric:.8g} "
                      f"rel={rel:.3g}")
        max_rel_seen = max(max_rel_seen, rel)
    if print_results:
        print(f"checked {k}/{n} params, max rel error {max_rel_seen:.3g}, "
              f"{fails} failures")
    return fails == 0


def _require_float64(net) -> None:
    if net.dtype != torch.float64:
        raise ValueError("Gradient checks require dtype='float64' "
                         "(reference enforces DataBuffer.Type.DOUBLE)")


def _as64(net, v):
    """A feed (or a list of them, a graph's) as float64 on the network's
    device; None stays None."""
    if v is None:
        return None
    if isinstance(v, (list, tuple)):
        return [_as64(net, a) for a in v]
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=net.device, dtype=torch.float64)


def check_gradients(net, x, y, *, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    labels_mask=None, features_mask=None,
                    print_results: bool = False,
                    subset: Optional[int] = None, seed: int = 0) -> bool:
    """Central-difference check of the loss's gradient with respect to
    every parameter (``params_flat`` order) of a float64 network, on
    features ``x`` and labels ``y`` (lists for a graph of several inputs
    or outputs) under optional masks. True when no parameter fails."""
    _require_float64(net)
    x, y = _as64(net, x), _as64(net, y)
    lmask, fmask = _as64(net, labels_mask), _as64(net, features_mask)
    params = list(net._ordered_params())

    def loss():
        return net.loss_fn(x, y, train=False, labels_mask=lmask,
                           features_mask=fmask)
    return _check(loss, params, epsilon=epsilon, max_rel_error=max_rel_error,
                  min_abs_error=min_abs_error, subset=subset, seed=seed,
                  print_results=print_results)


def check_pretrain_gradients(net, layer_idx: int, x, *,
                             epsilon: float = 1e-6,
                             max_rel_error: float = 1e-3,
                             min_abs_error: float = 1e-8,
                             subset: Optional[int] = None, seed: int = 0,
                             rng_seed: int = 12345,
                             print_results: bool = False) -> bool:
    """Central-difference check of layer ``layer_idx``'s ``pretrain_loss``
    (a ``MultiLayerNetwork``'s) at its input, with the noise drawn once
    from a generator seeded ``rng_seed`` and held over every evaluation, so
    a reparameterized loss (the VAE's ELBO, the denoising autoencoder's)
    is a deterministic function of the parameters. The RBM's CD-k is not
    the gradient of its surrogate (the chain's sample is detached on
    purpose) and is refused, as the reference refuses it."""
    layer = net.layers[layer_idx]
    if hasattr(layer, "gibbs_chain"):
        raise ValueError(
            "RBM CD-k is not the gradient of its surrogate loss through the "
            "Gibbs chain (the detach is the point); central differences "
            "would disagree by construction")
    _require_float64(net)
    x = _as64(net, x)
    with torch.no_grad():
        feed = x if layer_idx == 0 else net.apply_fn(
            x, train=False, to_layer=layer_idx - 1)[-1]
        pre = net.conf.preprocessor(layer_idx)
        if pre is not None:
            feed = pre.apply(feed)
        gen = torch.Generator(device=net.device).manual_seed(rng_seed)
        noise = layer.pretrain_noise(feed, gen)
    params = [p for _, p in sorted(
        layer.param_dict().items(),
        key=lambda kv: list(layer.param_order).index(kv[0]))]
    return _check(lambda: layer.pretrain_loss_given(feed, noise), params,
                  epsilon=epsilon, max_rel_error=max_rel_error,
                  min_abs_error=min_abs_error, subset=subset, seed=seed,
                  print_results=print_results)
