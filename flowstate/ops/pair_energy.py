"""System energy kernels: total and per-particle LJ + external-well energies.

Equivalent of the reference's ``MCMC/energy_calculator.py``:

* ``total_energy_virial``     — full O(N^2) recompute
  (``energy_calculator.py:121-203``), as one fused distance-matrix expression
  instead of the reference's per-row Python loop.
* ``particle_energy_virial``  — single-particle energy vs all others
  (``energy_calculator.py:48-108``), used for O(N) move deltas.
* Hard-core overlap (any pair distance < 0.5) maps to ``+inf`` energy
  (``energy_calculator.py:73-76, 150-153``); under jit the Metropolis rule
  then rejects with probability 1 because ``exp(-beta * inf) == 0``.

The interaction is described by a static ``SystemSpec`` closed over by jit;
positions are the only traced state.  Everything vmaps over a leading chains
axis (see ``flowstate.mcmc``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from flowstate.ops.box import Box, min_image
from flowstate.ops.potentials import (
    HARD_CORE_RADIUS,
    double_well_potential,
    lennard_jones_energy_virial,
)


class SystemSpec(NamedTuple):
    """Static description of the interacting system (never traced).

    Mirrors the constructor arguments of the reference ``EnergyCalculator``
    (``energy_calculator.py:11-46``) plus the box.
    """

    num_particles: int
    box: Box
    num_wells: int = 0
    V0_list: Tuple[float, ...] = (-4.0, -4.2)
    r0: float = 1.0
    k: float = 10.0
    epsilon: float = 1.0
    sigma: float = 1.0
    cutoff: float = 2.5
    hard_core: float = HARD_CORE_RADIUS

    @classmethod
    def create(cls, num_particles: int, box: Box, num_wells: int = 0,
               V0_list: Sequence[float] = (-4.0, -4.2), r0: float = 1.0,
               k: float = 10.0, **kw) -> "SystemSpec":
        return cls(num_particles=num_particles, box=box, num_wells=num_wells,
                   V0_list=tuple(float(v) for v in V0_list), r0=float(r0),
                   k=float(k), **kw)


def _external_energy(spec: SystemSpec, positions: jnp.ndarray) -> jnp.ndarray:
    """Sum of external double-well energies over particles (0 if no wells)."""
    if spec.num_wells == 0:
        return jnp.zeros(positions.shape[:-2], dtype=positions.dtype)
    v = double_well_potential(
        positions, spec.box.size_x, spec.box.size_y,
        V0_list=list(spec.V0_list), r0=spec.r0, k=spec.k,
        num_wells=spec.num_wells)
    return jnp.sum(v, axis=-1)


def total_energy_virial(spec: SystemSpec,
                        positions: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Total energy and virial of an (N, 2) configuration.

    LJ over unique pairs + external wells; any pair inside the hard core
    yields ``(+inf, +inf)`` exactly like reference
    ``energy_calculator.py:150-153``.
    """
    n = spec.num_particles
    diff = positions[:, None, :] - positions[None, :, :]
    diff = min_image(diff, spec.box)
    sq = jnp.sum(diff * diff, axis=-1)
    iu, ju = np.triu_indices(n, k=1)
    pair_sq = sq[iu, ju]
    r = jnp.sqrt(jnp.maximum(pair_sq, 1e-24))

    e_pair, w_pair = lennard_jones_energy_virial(
        r, epsilon=spec.epsilon, sigma=spec.sigma,
        cutoff_constant=spec.cutoff, shift=True)
    energy = jnp.sum(e_pair) + _external_energy(spec, positions)
    virial = jnp.sum(w_pair)

    overlap = jnp.any(r < spec.hard_core)
    inf = jnp.asarray(jnp.inf, dtype=energy.dtype)
    return (jnp.where(overlap, inf, energy), jnp.where(overlap, inf, virial))


def particle_energy_virial(spec: SystemSpec, positions: jnp.ndarray,
                           idx: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Energy/virial of particle ``idx`` vs all others + its external energy.

    Reference ``energy_calculator.py:48-108``; ``idx`` may be traced.
    """
    # one-hot select instead of a vmapped dynamic gather
    sel = (jnp.arange(spec.num_particles) == idx)[:, None]
    p = jnp.sum(jnp.where(sel, positions, 0.0), axis=0)
    diff = min_image(p[None, :] - positions, spec.box)
    sq = jnp.sum(diff * diff, axis=-1)
    n = spec.num_particles
    self_mask = jnp.arange(n) == idx
    r = jnp.sqrt(jnp.maximum(sq, 1e-24))

    e_pair, w_pair = lennard_jones_energy_virial(
        r, epsilon=spec.epsilon, sigma=spec.sigma,
        cutoff_constant=spec.cutoff, shift=True)
    zero = jnp.zeros_like(e_pair)
    energy = jnp.sum(jnp.where(self_mask, zero, e_pair))
    virial = jnp.sum(jnp.where(self_mask, zero, w_pair))

    if spec.num_wells > 0:
        energy = energy + double_well_potential(
            p, spec.box.size_x, spec.box.size_y, V0_list=list(spec.V0_list),
            r0=spec.r0, k=spec.k, num_wells=spec.num_wells)

    overlap = jnp.any(jnp.where(self_mask, False, r < spec.hard_core))
    inf = jnp.asarray(jnp.inf, dtype=energy.dtype)
    return (jnp.where(overlap, inf, energy), jnp.where(overlap, inf, virial))


def pressure(spec: SystemSpec, virial: jnp.ndarray, beta: float) -> jnp.ndarray:
    """NVT virial pressure: ``rho / beta + W / (2 V)``.

    Reference ``monte_carlo.py:424``.
    """
    volume = spec.box.volume
    rho = spec.num_particles / volume
    return rho / beta + virial / (2.0 * volume)
