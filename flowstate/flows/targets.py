"""Energy targets for reverse-KLD training (pure jnp).

Equivalents of the reference's ``NF/normflows/Energy``:

* ``SimpleLJ``     — ``Energy/SimpleLJ.py:5-39``: min-image-wrapped pairwise
  LJ with a linearized hard core (r <= 0.82 -> -80(r-0.82)+30), divided by T.
  The reference prepends a phantom particle pinned at the origin
  (``SimpleLJ.py:21-23``, with a hardcoded ``device='cuda'``) — that is a
  reference artifact, NOT replicated here by default; enable
  ``phantom_origin=True`` for bug-compatible parity testing.
* ``DoubleWellLJ`` — ``Energy/SimpleLJ.py:42-128``: adds the tanh double well
  with centers (−bound/2, 0), (+bound/2, 0) in the centered frame.  The
  reference's per-particle/per-well Python loops become one broadcast.
* ``DWNormal``     — ``Energy/DW_normal.py:4-101``: per-coordinate 2-Gaussian
  mixture base/target.
* ``CoulombGas``   — ``Energy/Columnbgas.py:12-17``: 2D Coulomb-gas energy.

Each target exposes ``energy(x)`` over batches ``(B, dim)`` of flattened
coordinates in the centered NF frame (the reference's ``_energy``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class SimpleLJ:
    """Linearized-hard-core LJ energy on the torus; ref ``SimpleLJ.py:5-39``."""

    dim: int
    n_particles: int
    temperature: float
    bound: float
    breakpoint: float = 0.82
    phantom_origin: bool = False

    @property
    def n_dimensions(self) -> int:
        return self.dim // self.n_particles

    def _pair_distances(self, x: jnp.ndarray) -> jnp.ndarray:
        b = x.shape[0]
        pos = x.reshape(b, self.n_particles, self.n_dimensions)
        period = 2.0 * self.bound
        pos = pos - period * jnp.round(pos / period)  # SimpleLJ.py:20
        if self.phantom_origin:
            zeros = jnp.zeros((b, 1, self.n_dimensions), dtype=pos.dtype)
            pos = jnp.concatenate([zeros, pos], axis=1)  # SimpleLJ.py:21-23
        n = pos.shape[1]
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        # NOTE: the reference takes raw (non-min-image) differences here
        # (SimpleLJ.py:25-27) after wrapping absolute coords; matched.
        sq = jnp.sum(diff * diff, axis=-1)
        iu, ju = np.triu_indices(n, k=1)
        return jnp.sqrt(jnp.maximum(sq[:, iu, ju], 1e-24))

    def energy(self, x: jnp.ndarray) -> jnp.ndarray:
        r = self._pair_distances(x)
        bk = self.breakpoint
        lin = -80.0 * (r - bk) + 30.0
        inv6 = (1.0 / r) ** 6
        lj = 4.0 * (inv6 * inv6 - inv6)
        e = jnp.where(r <= bk, lin, lj)
        return jnp.sum(e, axis=-1) / self.temperature


@dataclasses.dataclass(frozen=True)
class DoubleWellLJ(SimpleLJ):
    """LJ + tanh double well in the centered frame; ref ``SimpleLJ.py:42-128``."""

    V0_list: Tuple[float, float] = (-4.0, -4.0)
    r0: float = 1.0
    k: float = 10.0

    def double_well_potential(self, positions: jnp.ndarray) -> jnp.ndarray:
        """positions: (B, N, 2) centered coords; returns (B,)."""
        L = 2.0 * self.bound
        centers = jnp.asarray([[-self.bound / 2.0, 0.0],
                               [self.bound / 2.0, 0.0]],
                              dtype=positions.dtype)  # SimpleLJ.py:55-58
        v0 = jnp.asarray(self.V0_list, dtype=positions.dtype)
        d = positions[:, :, None, :] - centers  # (B, N, W, 2)
        d = d - L * jnp.round(d / L)
        r = jnp.sqrt(jnp.sum(d * d, axis=-1))
        transition = 0.5 * (1.0 + jnp.tanh(self.k * (r - self.r0)))
        return jnp.sum(v0 * (1.0 - transition), axis=(-1, -2))

    def energy(self, x: jnp.ndarray) -> jnp.ndarray:
        lj = SimpleLJ.energy(self, x)
        b = x.shape[0]
        pos = x.reshape(b, self.n_particles, self.n_dimensions)
        return lj + self.double_well_potential(pos)


@dataclasses.dataclass(frozen=True)
class DWNormal:
    """Per-coordinate double-well normal target; ref ``Energy/DW_normal.py``.

    energy(x) = sum_i [ -log( exp(-(x_i-mu)^2/(2 s^2)) +
                         exp(-(x_i+mu)^2/(2 s^2)) ) ] / T
    """

    dim: int
    temperature: float = 1.0
    mu: float = 2.0
    sigma: float = 0.5

    def energy(self, x: jnp.ndarray) -> jnp.ndarray:
        s2 = 2.0 * self.sigma**2
        a = -((x - self.mu) ** 2) / s2
        b = -((x + self.mu) ** 2) / s2
        e = -jnp.logaddexp(a, b)
        return jnp.sum(e, axis=-1) / self.temperature


@dataclasses.dataclass(frozen=True)
class CoulombGas:
    """2D Coulomb-gas pair energy; ref ``Energy/Columnbgas.py:12-17``."""

    dim: int
    n_particles: int
    temperature: float = 1.0

    def energy(self, x: jnp.ndarray) -> jnp.ndarray:
        b = x.shape[0]
        nd = self.dim // self.n_particles
        pos = x.reshape(b, self.n_particles, nd)
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        sq = jnp.sum(diff * diff, axis=-1)
        iu, ju = np.triu_indices(self.n_particles, k=1)
        r = jnp.sqrt(jnp.maximum(sq[:, iu, ju], 1e-24))
        return -jnp.sum(jnp.log(r), axis=-1) / self.temperature
