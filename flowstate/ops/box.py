"""Periodic simulation box: vectorized PBC wrap / minimum-image kernels.

Equivalent of the reference's ``MCMC/simulation_box.py``
(``SimulationBox.apply_pbc`` :19, ``minimum_image`` :31, ``compute_distance``
:48, and the O(N) Python-loop ``compute_distances`` :58-65 — the hottest line
of the reference).  Here every operation is a pure, batched ``jnp`` function:
distances to all neighbours are one fused elementwise expression, and the whole thing
vmaps over chains.

The box is represented as a static ``Box`` NamedTuple of floats so it can be
closed over by ``jit`` without becoming a traced value (box size never changes
in the NVT ensemble).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Box(NamedTuple):
    """A rectangular 2D periodic box (static metadata, not a traced value).

    Mirrors reference ``SimulationBox`` (``MCMC/simulation_box.py:3-17``):
    ``volume`` is the 2D area.
    """

    size_x: float
    size_y: float

    @property
    def volume(self) -> float:
        return self.size_x * self.size_y

    @property
    def sizes(self) -> np.ndarray:
        return np.array([self.size_x, self.size_y], dtype=np.float32)

    @property
    def half_x(self) -> float:
        return self.size_x / 2.0

    @classmethod
    def square(cls, size: float) -> "Box":
        return cls(float(size), float(size))

    @classmethod
    def from_density(cls, num_particles: int, rho: float,
                     aspect_ratio: float = 1.0) -> "Box":
        """Box dimensions from density + aspect ratio.

        Matches reference ``MCMC/initialise.py:145-148``:
        ``area = N / rho``; ``Lx = sqrt(area * AR)``; ``Ly = sqrt(area / AR)``.
        """
        area = num_particles / rho
        return cls(float(np.sqrt(area * aspect_ratio)),
                   float(np.sqrt(area / aspect_ratio)))


def wrap_pbc(positions: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Wrap positions into [0, L) per dimension.

    Reference: ``SimulationBox.apply_pbc`` (``simulation_box.py:19-29``),
    vectorized over arbitrary leading dimensions (..., 2).
    """
    sizes = jnp.asarray([box.size_x, box.size_y], dtype=positions.dtype)
    return jnp.mod(positions, sizes)


def min_image(delta: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Minimum-image displacement for a (…, 2) displacement array.

    Reference: ``SimulationBox.minimum_image`` (``simulation_box.py:31-46``):
    ``delta -= L * round(delta / L)`` per dimension.
    """
    sizes = jnp.asarray([box.size_x, box.size_y], dtype=delta.dtype)
    return delta - sizes * jnp.round(delta / sizes)


def min_image_centered(delta: jnp.ndarray, half_box: float) -> jnp.ndarray:
    """Minimum image for the NF centered frame [-half_box, half_box]^d.

    Reference: ``NF/normflows/Energy/SimpleLJ.py:20``
    (``x - 2*bound*round(x/(2*bound))``).
    """
    period = 2.0 * half_box
    return delta - period * jnp.round(delta / period)


def distance(p1: jnp.ndarray, p2: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Minimum-image Euclidean distance between two (…, 2) position arrays.

    Reference: ``SimulationBox.compute_distance`` (``simulation_box.py:48-56``).
    """
    d = min_image(p1 - p2, box)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def distances_to_all(p: jnp.ndarray, others: jnp.ndarray,
                     box: Box) -> jnp.ndarray:
    """Distances from one position (2,) to a set (M, 2) in one fused op.

    Replaces the reference's per-pair Python loop
    ``SimulationBox.compute_distances`` (``simulation_box.py:58-65``).
    """
    d = min_image(p[None, :] - others, box)
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def pair_distance_matrix(positions: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Full (N, N) min-image distance matrix for a (N, 2) configuration.

    Diagonal entries are 0.  Safe for autodiff: the norm at zero separation is
    guarded via a masked sqrt (the diagonal gradient is zeroed).
    """
    diff = positions[:, None, :] - positions[None, :, :]
    diff = min_image(diff, box)
    sq = jnp.sum(diff * diff, axis=-1)
    # Guard sqrt(0) on the diagonal for autodiff friendliness.
    n = positions.shape[0]
    eye = jnp.eye(n, dtype=bool)
    sq_safe = jnp.where(eye, 1.0, sq)
    return jnp.where(eye, 0.0, jnp.sqrt(sq_safe))


def upper_triangle_distances(positions: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Unique pair distances (N*(N-1)/2,) in fixed (i<j) order."""
    n = positions.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    diff = min_image(positions[iu] - positions[ju], box)
    return jnp.sqrt(jnp.sum(diff * diff, axis=-1))
