"""The unsupervised pretraining layers: the variational autoencoder and the
restricted Boltzmann machine, with the VAE's reconstruction distributions.

Counterpart of ``deeplearning4j_tpu/nn/layers/variational.py``: the
Gaussian (``:44``), Bernoulli (``:78``), Exponential (``:108``) and
Composite (``:149``) reconstruction distributions and
``LossFunctionWrapper`` (``:130``); ``VariationalAutoencoder``
(``:193-355``), whose pretraining loss is the negative ELBO over
``num_samples`` reparameterized draws and whose supervised forward is the
mean of q(z|x) (the decoder takes no part and gets a zero gradient); and
``RBM`` (``:362-459``), pretrained by CD-k expressed as the free-energy
surrogate ``mean F(x) - mean F(v_model)`` with the Gibbs chain's sample
detached where the reference stops its gradient. Parameter names are the
reference's (``eW0``, ``eb0``, ..., ``pZXMeanW``, ``pZXLogStd2W``,
``dW0``, ..., ``pXZW``; an RBM's ``W``, ``b``, ``vb``).

Every random draw (a distribution's sample, the ELBO's and the
log-probability estimate's eps, the Gibbs chain's noise) is a draw from an
explicit ``torch.Generator`` through ``nn/tape.py`` and a plain function
of the noise it drew (``generate_given``, ``elbo_per_example_given``,
``gibbs_chain_given``, ``pretrain_loss_given``), so a test can hand the
port the reference's own noise. A Bernoulli draw is a uniform compared
with the probability, as ``jax.random.bernoulli`` draws it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..activations import get_activation
from ..conf.serde import register
from ..inputs import InputTypeFeedForward
from ..losses import get_loss
from ..tape import taped
from .base import LayerConf, maybe_dropout, resolve_ff_size

_LOG_2PI = math.log(2 * math.pi)


def _uniform(gen, like, lo=0.0):
    """Uniform noise in [lo, 1) shaped, typed and placed as ``like``."""
    u = torch.rand(like.shape, generator=gen, dtype=like.dtype,
                   device=like.device)
    return u if lo == 0.0 else lo + (1.0 - lo) * u


def _normal(gen, like):
    return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                       device=like.device)


# ---------------------------------------------------------------------------
# Reconstruction distributions p(x|z)
# ---------------------------------------------------------------------------

@register
@dataclass
class GaussianReconstructionDistribution:
    """p(x|z) = N(mu, exp(log_var)): the decoder gives [mu | log_var],
    2 x the data width; the activation applies to the mean half only."""
    activation: str = "identity"

    def input_size(self, data_size: int) -> int:
        return 2 * data_size

    def _split(self, pre):
        d = pre.shape[-1] // 2
        return get_activation(self.activation)(pre[..., :d]), pre[..., d:]

    def neg_log_prob(self, x, pre):
        mu, log_var = self._split(pre)
        ll = -0.5 * (_LOG_2PI + log_var + (x - mu) ** 2 / torch.exp(log_var))
        return -ll.sum(dim=-1)

    def generate_at_mean(self, pre):
        return self._split(pre)[0]

    def noise(self, gen, pre):
        return _normal(gen, self._split(pre)[0])

    def generate_given(self, pre, noise):
        mu, log_var = self._split(pre)
        return mu + torch.exp(0.5 * log_var) * noise


@register
@dataclass
class BernoulliReconstructionDistribution:
    """p(x|z) = Bernoulli(act(pre)) for binary or binarized data; with the
    sigmoid it takes the stable ``logsigmoid`` form."""
    activation: str = "sigmoid"

    def input_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob(self, x, pre):
        if self.activation == "sigmoid":
            ll = x * F.logsigmoid(pre) + (1 - x) * F.logsigmoid(-pre)
        else:
            p = torch.clamp(get_activation(self.activation)(pre), 1e-10,
                            1 - 1e-10)
            ll = x * torch.log(p) + (1 - x) * torch.log1p(-p)
        return -ll.sum(dim=-1)

    def generate_at_mean(self, pre):
        return get_activation(self.activation)(pre)

    def noise(self, gen, pre):
        return _uniform(gen, pre)

    def generate_given(self, pre, noise):
        return (noise < get_activation(self.activation)(pre)).to(pre.dtype)


@register
@dataclass
class ExponentialReconstructionDistribution:
    """p(x|z) = lambda exp(-lambda x) with lambda = exp(act(pre))."""
    activation: str = "identity"

    def input_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob(self, x, pre):
        gamma = get_activation(self.activation)(pre)
        return -(gamma - x * torch.exp(gamma)).sum(dim=-1)

    def generate_at_mean(self, pre):
        return torch.exp(-get_activation(self.activation)(pre))

    def noise(self, gen, pre):
        return _uniform(gen, pre, lo=1e-10)

    def generate_given(self, pre, noise):
        lam = torch.exp(get_activation(self.activation)(pre))
        return -torch.log(noise) / lam


@register
@dataclass
class LossFunctionWrapper:
    """A loss function as a (non-probabilistic) reconstruction
    "distribution": the VAE trains on reconstruction error plus KL."""
    loss: str = "mse"
    activation: str = "identity"

    def input_size(self, data_size: int) -> int:
        return data_size

    def neg_log_prob(self, x, pre):
        return get_loss(self.loss)(x, pre, self.activation, None)

    def generate_at_mean(self, pre):
        return get_activation(self.activation)(pre)

    def noise(self, gen, pre):
        return None

    def generate_given(self, pre, noise):
        return self.generate_at_mean(pre)


@register
@dataclass
class CompositeReconstructionDistribution:
    """Column slices of the data, each with its own distribution:
    ``parts`` is a list of (data width, distribution) pairs covering the
    columns in order."""
    parts: List[Any] = field(default_factory=list)

    def input_size(self, data_size: int) -> int:
        total = sum(int(s) for s, _ in self.parts)
        if data_size != total:
            raise ValueError(f"Composite part sizes sum to {total}, but the "
                             f"layer input size is {data_size}")
        return sum(d.input_size(int(s)) for s, d in self.parts)

    def _slices(self):
        x_off, p_off = 0, 0
        for s, d in self.parts:
            s = int(s)
            ps = d.input_size(s)
            yield x_off, s, p_off, ps, d
            x_off += s
            p_off += ps

    def neg_log_prob(self, x, pre):
        total = 0.0
        for x0, xs, p0, ps, d in self._slices():
            total = total + d.neg_log_prob(x[..., x0:x0 + xs],
                                           pre[..., p0:p0 + ps])
        return total

    def generate_at_mean(self, pre):
        return torch.cat([d.generate_at_mean(pre[..., p0:p0 + ps])
                          for _, _, p0, ps, d in self._slices()], dim=-1)

    def noise(self, gen, pre):
        return [d.noise(gen, pre[..., p0:p0 + ps])
                for _, _, p0, ps, d in self._slices()]

    def generate_given(self, pre, noise):
        return torch.cat([d.generate_given(pre[..., p0:p0 + ps], n)
                          for (_, _, p0, ps, d), n in zip(self._slices(),
                                                          noise)], dim=-1)


def generate_random(dist, gen, pre):
    """A sample of ``dist`` at the decoder output ``pre``: its noise drawn
    from ``gen`` (through the tape), then ``generate_given``."""
    return dist.generate_given(pre, taped(lambda: dist.noise(gen, pre)))


# ---------------------------------------------------------------------------
# VariationalAutoencoder
# ---------------------------------------------------------------------------

@register
class VariationalAutoencoder(LayerConf):
    """The VAE layer: pretrained on the reparameterized negative ELBO; in a
    supervised stack its forward is mean(q(z|x)) through
    ``pzx_activation``. ``n_out`` is the latent width."""
    serde_fields = LayerConf.serde_fields + (
        "n_in", "n_out", "encoder_layer_sizes", "decoder_layer_sizes",
        "reconstruction_distribution", "pzx_activation", "num_samples")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 encoder_layer_sizes=(100,), decoder_layer_sizes=(100,),
                 reconstruction_distribution=None,
                 pzx_activation: str = "identity", num_samples: int = 1,
                 **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out
        self.encoder_layer_sizes = tuple(encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(decoder_layer_sizes)
        self.reconstruction_distribution = (
            GaussianReconstructionDistribution()
            if reconstruction_distribution is None
            else reconstruction_distribution)
        self.pzx_activation = pzx_activation
        self.num_samples = num_samples

    @property
    def param_order(self) -> Tuple[str, ...]:
        """The encoder stack, the q(z|x) mean and log-variance heads, the
        decoder stack, the p(x|z) head."""
        names = [n for i in range(len(self.encoder_layer_sizes))
                 for n in (f"eW{i}", f"eb{i}")]
        names += ["pZXMeanW", "pZXMeanb", "pZXLogStd2W", "pZXLogStd2b"]
        names += [n for i in range(len(self.decoder_layer_sizes))
                  for n in (f"dW{i}", f"db{i}")]
        return tuple(names + ["pXZW", "pXZb"])

    def supervised_params(self) -> Tuple[str, ...]:
        """The parameters the supervised forward uses: the encoder and the
        mean head (the rest are pretrain-only)."""
        return tuple(n for i in range(len(self.encoder_layer_sizes))
                     for n in (f"eW{i}", f"eb{i}")) + ("pZXMeanW",
                                                       "pZXMeanb")

    @property
    def weight_param_names(self) -> Tuple[str, ...]:
        """What l1/l2 act on in the supervised loss: the supervised
        weights only, so a pretrained decoder is not decayed."""
        return tuple(n for n in self.supervised_params() if "W" in n)

    def output_type(self, itype):
        return InputTypeFeedForward(self.n_out)

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or resolve_ff_size(itype)
        self.n_in = n_in

        def dense(w, b, fi, fo):
            setattr(self, w, self._winit(gen, (fi, fo), fi, fo, dtype,
                                         device))
            setattr(self, b, self._binit((fo,), dtype, device))

        cur = n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            dense(f"eW{i}", f"eb{i}", cur, h)
            cur = h
        dense("pZXMeanW", "pZXMeanb", cur, self.n_out)
        dense("pZXLogStd2W", "pZXLogStd2b", cur, self.n_out)
        cur = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            dense(f"dW{i}", f"db{i}", cur, h)
            cur = h
        dense("pXZW", "pXZb", cur,
              self.reconstruction_distribution.input_size(n_in))

    # ---- encoder and decoder ----
    def _encoder_hidden(self, x):
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = self.act(h @ getattr(self, f"eW{i}") + getattr(self, f"eb{i}"))
        return h

    def encode(self, x):
        """q(z|x): (mean, log-variance), both through ``pzx_activation``."""
        h = self._encoder_hidden(x)
        act = get_activation(self.pzx_activation)
        return (act(h @ self.pZXMeanW + self.pZXMeanb),
                act(h @ self.pZXLogStd2W + self.pZXLogStd2b))

    def decode(self, z):
        """The p(x|z) distribution's parameters (pre-activation)."""
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = self.act(h @ getattr(self, f"dW{i}") + getattr(self, f"db{i}"))
        return h @ self.pXZW + self.pXZb

    def forward(self, x, *, train=False, gen=None):
        h = self._encoder_hidden(maybe_dropout(x, self.dropout, gen, train))
        return get_activation(self.pzx_activation)(
            h @ self.pZXMeanW + self.pZXMeanb)

    # ---- pretraining: the negative ELBO ----
    def _eps(self, x, gen, n):
        shape = (n, x.shape[0], self.n_out)
        return taped(lambda: torch.randn(shape, generator=gen, dtype=x.dtype,
                                         device=x.device))

    def elbo_per_example_given(self, x, eps):
        """The negative ELBO per example, KL(q(z|x) || N(0, I)) plus the
        mean over the draws eps [num_samples, B, n_out] of -log p(x|z)."""
        mu, log_var = self.encode(x)
        kl = -0.5 * torch.sum(1 + log_var - mu ** 2 - torch.exp(log_var),
                              dim=-1)
        recon = 0.0
        for e in eps:
            z = mu + torch.exp(0.5 * log_var) * e
            recon = recon + self.reconstruction_distribution.neg_log_prob(
                x, self.decode(z))
        return kl + recon / len(eps)

    def elbo_per_example(self, x, gen):
        return self.elbo_per_example_given(
            x, self._eps(x, gen, self.num_samples))

    def pretrain_noise(self, x, gen):
        return self._eps(x, gen, self.num_samples)

    def pretrain_loss_given(self, x, eps):
        return self.elbo_per_example_given(x, eps).mean()

    def pretrain_loss(self, x, gen):
        return self.pretrain_loss_given(x, self.pretrain_noise(x, gen))

    # ---- the generative calls ----
    def reconstruction_log_probability_given(self, x, eps):
        """The importance-sampling estimate of log p(x) over the draws eps
        [S, B, n_out]: log mean_s exp(log p(x|z_s) + log p(z_s) - log
        q(z_s|x))."""
        mu, log_var = self.encode(x)
        log_ws = []
        for e in eps:
            z = mu + torch.exp(0.5 * log_var) * e
            log_p_xz = -self.reconstruction_distribution.neg_log_prob(
                x, self.decode(z))
            log_p_z = -0.5 * torch.sum(_LOG_2PI + z ** 2, dim=-1)
            log_q = -0.5 * torch.sum(_LOG_2PI + log_var + e ** 2, dim=-1)
            log_ws.append(log_p_xz + log_p_z - log_q)
        return torch.logsumexp(torch.stack(log_ws), dim=0) - math.log(
            float(len(eps)))

    def reconstruction_log_probability(self, x, num_samples: int = 5,
                                       gen: Optional[torch.Generator] = None):
        """``reconstruction_log_probability_given`` over ``num_samples``
        draws from ``gen`` (default: a generator on x's device seeded 0)."""
        if gen is None:
            gen = torch.Generator(device=x.device).manual_seed(0)
        return self.reconstruction_log_probability_given(
            x, self._eps(x, gen, num_samples))

    def generate_at_mean_given_z(self, z):
        return self.reconstruction_distribution.generate_at_mean(
            self.decode(z))

    def generate_random_given_z(self, z, gen):
        return generate_random(self.reconstruction_distribution, gen,
                               self.decode(z))


# ---------------------------------------------------------------------------
# RBM
# ---------------------------------------------------------------------------

@register
class RBM(LayerConf):
    """Restricted Boltzmann machine: as a layer it is ``act(x @ W + b)``
    (sigmoid unless set); pretrained with CD-k as the free-energy
    surrogate. Hidden units are "binary" or "rectified" (NReLU), visible
    units "binary" or "gaussian"."""
    serde_fields = LayerConf.serde_fields + (
        "n_in", "n_out", "hidden_unit", "visible_unit", "k")
    param_order = ("W", "b", "vb")

    def __init__(self, n_in: Optional[int] = None, n_out: int = 0,
                 hidden_unit: str = "binary", visible_unit: str = "binary",
                 k: int = 1, **kw):
        super().__init__(**kw)
        self.n_in = n_in
        self.n_out = n_out
        self.hidden_unit = hidden_unit
        self.visible_unit = visible_unit
        self.k = k

    def output_type(self, itype):
        return InputTypeFeedForward(self.n_out)

    def init_params(self, itype, dtype, device, gen):
        n_in = self.n_in or resolve_ff_size(itype)
        self.n_in = n_in
        self.W = self._winit(gen, (n_in, self.n_out), n_in, self.n_out,
                             dtype, device)
        self.b = self._binit((self.n_out,), dtype, device)
        self.vb = self._binit((n_in,), dtype, device)

    def forward(self, x, *, train=False, gen=None):
        x = maybe_dropout(x, self.dropout, gen, train)
        return get_activation(self.activation or "sigmoid")(
            x @ self.W + self.b)

    def free_energy(self, v):
        """F(v) = -v·vb - Σ G(v W + b): G is softplus for binary hidden
        units and 0.5 relu(pre)² for rectified ones; gaussian visible units
        take 0.5 ||v - vb||² for the linear term."""
        pre_h = v @ self.W + self.b
        if self.hidden_unit == "rectified":
            hidden = torch.sum(0.5 * torch.clamp(pre_h, min=0.0) ** 2, dim=-1)
        else:
            hidden = torch.sum(F.softplus(pre_h), dim=-1)
        if self.visible_unit == "gaussian":
            return 0.5 * torch.sum((v - self.vb) ** 2, dim=-1) - hidden
        return -(v @ self.vb) - hidden

    def gibbs_noise(self, v0, gen, k: Optional[int] = None):
        """The noise of k Gibbs steps: per step (hidden, visible) noise,
        uniform for a binary unit's draw, standard normal for a rectified
        hidden or gaussian visible one."""
        def draw():
            h_like = v0.new_empty((v0.shape[0], self.n_out))
            steps = []
            for _ in range(k or self.k):
                nh = (_normal(gen, h_like) if self.hidden_unit == "rectified"
                      else _uniform(gen, h_like))
                nv = (_normal(gen, v0) if self.visible_unit == "gaussian"
                      else _uniform(gen, v0))
                steps.append((nh, nv))
            return steps
        return taped(draw)

    def _sample_h(self, v, noise):
        pre = v @ self.W + self.b
        if self.hidden_unit == "rectified":
            return torch.clamp(pre + noise * torch.sqrt(torch.sigmoid(pre)),
                               min=0.0)
        return (noise < torch.sigmoid(pre)).to(v.dtype)

    def _sample_v(self, h, noise):
        pre = h @ self.W.T + self.vb
        if self.visible_unit == "gaussian":
            return pre + noise
        return (noise < torch.sigmoid(pre)).to(h.dtype)

    def gibbs_chain_given(self, v0, noise):
        """Alternating Gibbs steps v -> h -> v' driven by ``noise``
        (``gibbs_noise``)."""
        v = v0
        for nh, nv in noise:
            v = self._sample_v(self._sample_h(v, nh), nv)
        return v

    def gibbs_chain(self, v0, gen, k: Optional[int] = None):
        return self.gibbs_chain_given(v0, self.gibbs_noise(v0, gen, k))

    def pretrain_noise(self, x, gen):
        return self.gibbs_noise(x, gen)

    def pretrain_loss_given(self, x, noise):
        """mean F(x) - mean F(v_model), the chain's sample detached: its
        gradient is the CD-k update."""
        v_model = self.gibbs_chain_given(x, noise).detach()
        return self.free_energy(x).mean() - self.free_energy(v_model).mean()

    def pretrain_loss(self, x, gen):
        return self.pretrain_loss_given(x, self.pretrain_noise(x, gen))

    def reconstruct(self, x):
        """One mean-field step v -> h -> v with each unit's conditional
        mean."""
        pre_h = x @ self.W + self.b
        h = (torch.clamp(pre_h, min=0.0) if self.hidden_unit == "rectified"
             else torch.sigmoid(pre_h))
        pre_v = h @ self.W.T + self.vb
        return pre_v if self.visible_unit == "gaussian" else torch.sigmoid(
            pre_v)
