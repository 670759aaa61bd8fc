"""Estimator-style pipeline wrappers (fit/predict/score).

Counterpart of ``deeplearning4j_tpu/ml.py``: ``NeuralNetClassifier`` and
``NeuralNetRegressor`` over the port's ``MultiLayerNetwork``, with the
reference's clone semantics (``:16-45``). The network lives on its own
device (a configuration builds one on ``device``, the card unless the
caller names another); ``net.output`` answers with a tensor there, which
``predict_proba`` and ``predict`` copy to the host once.

Reference: deeplearning4j-scaleout spark/dl4j-spark-ml —
SparkDl4jNetwork.scala wraps the network as an org.apache.spark.ml
Estimator/Model so it slots into ML pipelines. The Python-ecosystem analogue
is the scikit-learn estimator contract: ``fit(X, y)`` / ``predict`` /
``predict_proba`` / ``score``, integer or one-hot labels accepted.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .device import DeviceLike


class NeuralNetClassifier:
    """sklearn-style classifier around a MultiLayerConfiguration (or an
    already-built network).

    Clone semantics: the wrapper OWNS its network. When constructed from a
    built net it trains a clone (warm-started from that net's weights), so
    sklearn ``clone``/``cross_val_score`` — which reconstruct estimators via
    ``get_params`` — get independent networks instead of sharing one set of
    mutable weights across folds.
    """

    def __init__(self, conf_or_net, *, epochs: int = 10, batch_size: int = 32,
                 device: DeviceLike = None):
        self.conf_or_net = conf_or_net
        self.epochs = epochs
        self.batch_size = batch_size
        self.device = device     # where a network built from a conf lives
        self.net = None          # built lazily by fit() (no wasted clone)
        self.n_classes_: Optional[int] = None

    def _build_net(self):
        src = self.conf_or_net
        if hasattr(src, "fit"):      # built network: train an independent clone
            if not hasattr(src, "clone"):
                raise ValueError(
                    "Wrapped networks must support clone() so the estimator "
                    "owns independent weights (sklearn clone/cross-val would "
                    "otherwise share one mutable network across folds)")
            self.net = src.clone()
        else:
            from .nn.multilayer import MultiLayerNetwork
            self.net = MultiLayerNetwork(src, device=self.device)

    def _output_width(self) -> Optional[int]:
        layers = getattr(getattr(self.net, "conf", None), "layers", None)
        if layers:
            n = getattr(layers[-1], "n_out", None)
            if n:
                return int(n)
        return None

    def _one_hot(self, y):
        y = np.asarray(y)
        if y.ndim == 2:          # already one-hot
            self.n_classes_ = y.shape[1]
            return y.astype(np.float32)
        # width comes from the net's output layer when known, so a refit
        # batch that happens to miss the top class still encodes correctly
        self.n_classes_ = self._output_width() or int(y.max()) + 1
        return np.eye(self.n_classes_, dtype=np.float32)[y.astype(int)]

    def fit(self, X, y, **fit_kwargs):
        # sklearn fit() contract: every fit restarts from the construction
        # point (fresh init from a conf, or a fresh clone of the source net)
        self._build_net()
        Y = self._one_hot(y)
        self.net.fit(np.asarray(X, np.float32), Y, epochs=self.epochs,
                     batch_size=self.batch_size, **fit_kwargs)
        return self

    def _require_net(self):
        if self.net is None:
            if hasattr(self.conf_or_net, "fit"):
                # wrapped pre-trained network: inference without fit() is
                # legitimate — build the owned clone lazily
                self._build_net()
            else:
                raise ValueError(
                    "This estimator is not fitted yet; call fit() first")
        return self.net

    def _output(self, X) -> np.ndarray:
        """The network's output for ``X``, copied to the host."""
        out = self._require_net().output(np.asarray(X, np.float32))
        return out.detach().cpu().numpy()

    def predict_proba(self, X) -> np.ndarray:
        return self._output(X)

    def predict(self, X) -> np.ndarray:
        return self.predict_proba(X).argmax(-1)

    def score(self, X, y) -> float:
        """Mean accuracy (sklearn contract)."""
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(-1)
        return float((self.predict(X) == y).mean())

    def get_params(self, deep: bool = True):
        return {"conf_or_net": self.conf_or_net, "epochs": self.epochs,
                "batch_size": self.batch_size, "device": self.device}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        if "conf_or_net" in params:      # new architecture -> refit required
            self.net = None
            self.n_classes_ = None
        return self


class NeuralNetRegressor(NeuralNetClassifier):
    """sklearn-style regressor: targets pass through; score is R^2."""

    def fit(self, X, y, **fit_kwargs):
        self._build_net()
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self.net.fit(np.asarray(X, np.float32), y, epochs=self.epochs,
                     batch_size=self.batch_size, **fit_kwargs)
        return self

    def predict(self, X) -> np.ndarray:
        out = self._output(X)
        return out[:, 0] if out.shape[-1] == 1 else out

    def score(self, X, y) -> float:
        y = np.asarray(y, np.float64).reshape(-1)
        pred = np.asarray(self.predict(X), np.float64).reshape(-1)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-12)
