"""Normalization flow layers: ActNorm and batch-stat BatchNorm.

Equivalents of ``NF/normflows/flows/normalization.py``:

* ``ActNorm``  — AffineConstFlow with data-dependent init (Glow paper;
  ``normalization.py:7-40``).  The reference hides the init inside the
  first forward call (mutating buffers); here it is the explicit
  ``init_params_from_data`` — stateless thereafter.
* ``BatchNorm`` — batch-statistics whitening without stat derivatives
  (``normalization.py:43-62``); forward-only, not bijective per-sample.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from flowstate.flows.affine import AffineConstFlow


@dataclasses.dataclass(frozen=True)
class ActNorm(AffineConstFlow):
    """Data-dependent-init affine const flow; ref ``normalization.py:7-40``."""

    def init_params_from_data(self, z: jnp.ndarray):
        """Choose (s, t) so the first batch maps to zero mean / unit std."""
        s = -jnp.log(jnp.std(z, axis=0) + 1e-6)
        t = -jnp.mean(z, axis=0) * jnp.exp(s)
        return {"s": s, "t": t}


@dataclasses.dataclass(frozen=True)
class BatchNorm:
    """Whitening by current-batch statistics; ref ``normalization.py:43-62``."""

    eps: float = 1e-10

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        mean = jnp.mean(z, axis=0, keepdims=True)
        std = jnp.std(z, axis=0, keepdims=True, ddof=1)
        denom = jnp.sqrt(std**2 + self.eps)
        z_ = (z - mean) / denom
        log_det = jnp.broadcast_to(-jnp.sum(jnp.log(denom)), (z.shape[0],))
        return z_, log_det

    def inverse(self, params, z):
        raise NotImplementedError(
            "BatchNorm uses batch statistics and has no pointwise inverse.")
