"""Data-preprocessing flow layers: Logit and Shift.

Equivalents of ``NF/normflows/transforms.py``:

* ``LogitTransform`` — RealNVP-style logit dequantization flow with exact
  log-dets (``transforms.py:8-48``).  (Distinct from the stateless
  dataloader ``Logit`` in ``flows/utils.py``, which mirrors
  ``utils/preprocessing.py``.)
* ``Shift``          — constant shift flow (``transforms.py:51-77``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.coupling import sum_except_batch


@dataclasses.dataclass(frozen=True)
class LogitTransform:
    """logit(alpha + (1-2 alpha) x) flow; ref ``transforms.py:8-48``.

    forward: latent (logit space) -> data in [0, 1];
    inverse: data -> logit space (the training direction).
    """

    alpha: float = 0.05

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        beta = 1.0 - 2.0 * self.alpha
        d = float(np.prod(z.shape[1:]))
        ls = sum_except_batch(jax.nn.log_sigmoid(z))
        mls = sum_except_batch(jax.nn.log_sigmoid(-z))
        log_det = -np.log(beta) * d + ls + mls
        out = (jax.nn.sigmoid(z) - self.alpha) / beta
        return out, log_det

    def inverse(self, params, z):
        beta = 1.0 - 2.0 * self.alpha
        x = self.alpha + beta * z
        logx = jnp.log(x)
        log1mx = jnp.log(1.0 - x)
        out = logx - log1mx
        d = float(np.prod(z.shape[1:]))
        log_det = (np.log(beta) * d - sum_except_batch(logx)
                   - sum_except_batch(log1mx))
        return out, log_det


@dataclasses.dataclass(frozen=True)
class Shift:
    """Constant shift flow; ref ``transforms.py:51-77``."""

    shift: float = -0.5

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        return z - self.shift, jnp.zeros(z.shape[0], dtype=z.dtype)

    def inverse(self, params, z):
        return z + self.shift, jnp.zeros(z.shape[0], dtype=z.dtype)
