"""Every loss of the port (deeplearning4j_tpu_torch/nn/losses.py) against
the JAX package's, by every registered name, with and without a mask, on
the same float32 inputs made with numpy. Tolerance 1e-6."""
import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu_torch.nn import losses as tlosses

TOL = 1e-6


def _activation(name):
    if name in ("mcxent", "negativeloglikelihood", "categorical_crossentropy",
                "sparse_mcxent"):
        return "softmax"
    if name in ("hinge", "squared_hinge"):
        return "tanh"
    if name == "cosine_proximity":
        return "identity"
    return "sigmoid"


def _inputs(name, seed, shape):
    r = np.random.default_rng(seed)
    pre = r.normal(size=shape).astype(np.float32)
    if name == "sparse_mcxent":
        labels = r.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    elif name in ("hinge", "squared_hinge"):
        labels = np.where(r.random(shape) > 0.5, 1.0, -1.0).astype(np.float32)
    elif name in ("mcxent", "negativeloglikelihood",
                  "categorical_crossentropy"):
        labels = np.eye(shape[-1], dtype=np.float32)[
            r.integers(0, shape[-1], size=shape[:-1])]
    else:
        labels = r.random(shape).astype(np.float32) + 0.05
    return labels, pre


def test_registries_name_the_same_losses():
    assert tlosses.loss_names() == jlosses.loss_names()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", jlosses.loss_names())
def test_loss_matches_jax(name, masked):
    for seed, shape, mshape in ((1, (4, 5), (4,)), (2, (2, 3, 5), (2, 3))):
        labels, pre = _inputs(name, seed, shape)
        mask = None
        if masked:
            mask = (np.random.default_rng(seed + 9).random(mshape) > 0.4) \
                .astype(np.float32)
        act = _activation(name)
        ours = tlosses.get_loss(name)(
            torch.from_numpy(labels), torch.from_numpy(pre), act,
            None if mask is None else torch.from_numpy(mask))
        ref = jlosses.get_loss(name)(
            jnp.asarray(labels), jnp.asarray(pre), act,
            None if mask is None else jnp.asarray(mask))
        assert ours.shape == (shape[0],)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL, err_msg=str(shape))


@pytest.mark.parametrize("name,act", [("xent", "softmax"),
                                      ("mcxent", "sigmoid")])
def test_clipped_forms_match_jax(name, act):
    """The cross-entropies' clipped paths, taken when the activation is
    not the one their fused form is for."""
    labels, pre = _inputs("xent", 3, (2, 3, 5))
    ours = tlosses.get_loss(name)(torch.from_numpy(labels),
                                  torch.from_numpy(pre), act)
    ref = jlosses.get_loss(name)(jnp.asarray(labels), jnp.asarray(pre), act)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_unknown_loss_names_the_available_ones():
    with pytest.raises(ValueError, match="available"):
        tlosses.get_loss("no_such_loss")
