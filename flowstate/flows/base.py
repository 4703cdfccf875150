"""Flow base adapters: Reverse and Composite.

Equivalents of ``NF/normflows/flows/base.py``:

* ``Reverse``   — swaps a layer's forward/inverse (``base.py:27-45``)
* ``Composite`` — chains layers into one (``base.py:48-81``)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Reverse:
    """A layer with forward and inverse swapped; ref ``base.py:27-45``."""

    layer: Any

    def init_params(self, key: jax.Array):
        return self.layer.init_params(key)

    def forward(self, params, z):
        return self.layer.inverse(params, z)

    def inverse(self, params, z):
        return self.layer.forward(params, z)


@dataclasses.dataclass(frozen=True)
class Composite:
    """Several layers fused into one; ref ``base.py:48-81``."""

    layers: Tuple[Any, ...]

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.layers))
        return tuple(l.init_params(k) for l, k in zip(self.layers, keys))

    def forward(self, params, z):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        for layer, p in zip(self.layers, params):
            z, ld = layer.forward(p, z)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, params, z):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        for layer, p in zip(reversed(self.layers), reversed(params)):
            z, ld = layer.inverse(p, z)
            log_det = log_det + ld
        return z, log_det
