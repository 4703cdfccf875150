"""Periodic coordinate wrap/shift flows.

Equivalents of ``NF/normflows/flows/periodic.py``:

* ``PeriodicWrap``  — wrap selected coords back into [-bound, bound) on the
  inverse pass (``periodic.py:6-32``)
* ``PeriodicShift`` — shift + wrap on forward, unshift + wrap on inverse
  (``periodic.py:35-73``)

Both are volume-preserving (log-det 0) on the torus.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _wrap(x, bound, shift=0.0):
    return jnp.mod(x + shift + bound, 2.0 * bound) - bound


@dataclasses.dataclass(frozen=True)
class PeriodicWrap:
    ind: Tuple[int, ...]
    bound: float = 1.0

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        return z, jnp.zeros(z.shape[0], dtype=z.dtype)

    def inverse(self, params, z):
        idx = np.asarray(self.ind)
        z = z.at[..., idx].set(_wrap(z[..., idx], self.bound))
        return z, jnp.zeros(z.shape[0], dtype=z.dtype)


@dataclasses.dataclass(frozen=True)
class PeriodicShift:
    ind: Tuple[int, ...]
    bound: float = 1.0
    shift: float = 0.0

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        idx = np.asarray(self.ind)
        z = z.at[..., idx].set(_wrap(z[..., idx], self.bound, self.shift))
        return z, jnp.zeros(z.shape[0], dtype=z.dtype)

    def inverse(self, params, z):
        idx = np.asarray(self.ind)
        z = z.at[..., idx].set(_wrap(z[..., idx], self.bound, -self.shift))
        return z, jnp.zeros(z.shape[0], dtype=z.dtype)
