"""Physics potentials as pure jnp kernels.

Equivalents of the reference's ``MCMC/potential.py``:

* ``lennard_jones_energy_virial``  — truncated-shifted LJ (``potential.py:3-29``)
* ``lennard_jones_force``          — LJ pair force (``potential.py:38-46``)
* ``tail_correction_energy_2d``    — 2D energy tail correction (``potential.py:31-36``)
* ``tail_correction_pressure_2d``  — 2D pressure tail correction (``potential.py:48-53``)
* ``double_well_potential``        — tanh flat-bottom double well with per-well
                                     depths (``potential.py:55-116``)
* ``double_well_potential_equal``  — legacy equal-depth variant (``potential.py:120-185``)
* ``gaussian_double_well``         — legacy Gaussian-well variant (``potential.py:187-223``)

All functions are branchless (``jnp.where`` masking instead of boolean
indexing), shape-polymorphic over leading dims, and differentiable, so they
can be fused by XLA inside the Metropolis move kernel and vmapped over chains.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

# Default well parameters of the hybrid experiments
# (reference main_algorithm_1.py:47-49).
DEFAULT_V0_LIST = (-4.0, -4.0)

# Pair distances below this are treated as a hard-core overlap by the energy
# calculator (reference energy_calculator.py:73-76, 150-153).
HARD_CORE_RADIUS = 0.5


def lennard_jones_energy_virial(
    r: jnp.ndarray,
    epsilon: float = 1.0,
    sigma: float = 1.0,
    cutoff_constant: float = 2.5,
    shift: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Truncated (and optionally shifted) Lennard-Jones pair energy + virial.

    Semantics match reference ``potential.py:3-29``: for r <= r_cut,
    ``e = 4 eps (sr12 - sr6) [- e(r_cut) if shift]``,
    ``w = 48 eps (sr12 - 0.5 sr6)``; both are 0 beyond the cutoff.

    ``r`` may have any shape; division by zero is guarded by clamping, the
    hard-core region is handled upstream (see ``pair_energy``).
    """
    r = jnp.asarray(r)
    r_cut = cutoff_constant  # sigma = 1 convention, as in the reference
    mask = r <= r_cut
    r_safe = jnp.maximum(r, 1e-12)
    sr6 = (sigma / r_safe) ** 6
    sr12 = sr6 * sr6
    energy = 4.0 * epsilon * (sr12 - sr6)
    virial = 48.0 * epsilon * (sr12 - 0.5 * sr6)
    if shift:
        sr6_cut = (sigma / r_cut) ** 6
        sr12_cut = sr6_cut * sr6_cut
        energy = energy - 4.0 * epsilon * (sr12_cut - sr6_cut)
    zero = jnp.zeros_like(energy)
    return jnp.where(mask, energy, zero), jnp.where(mask, virial, zero)


def lennard_jones_force(
    r: jnp.ndarray,
    epsilon: float = 1.0,
    sigma: float = 1.0,
    cutoff_constant: float = 2.5,
) -> jnp.ndarray:
    """Scalar LJ pair force magnitude; reference ``potential.py:38-46``.

    NOTE (reference-faithful inconsistency): the force cutoff is
    ``cutoff_constant * sigma`` (potential.py:40) while the energy cutoff
    is the bare ``cutoff_constant`` (potential.py:6-7, sigma=1 convention)
    — the two disagree for sigma != 1.  The force is never called from any
    reference driver; kept for API parity.
    """
    r = jnp.asarray(r)
    r_cut = cutoff_constant * sigma
    mask = (r > 0) & (r <= r_cut)
    r_safe = jnp.maximum(r, 1e-12)
    sr6 = (sigma / r_safe) ** 6
    sr12 = sr6 * sr6
    force = 24.0 * epsilon * (2.0 * sr12 - sr6) / r_safe
    return jnp.where(mask, force, jnp.zeros_like(force))


def tail_correction_energy_2d(rho: float, num_particles: int, r_cut: float,
                              epsilon: float = 1.0,
                              sigma: float = 1.0) -> float:
    """2D LJ energy tail correction; reference ``potential.py:31-36``.

    (Defined but never called from the reference MC loop — kept for parity.)
    """
    return (8.0 * jnp.pi * epsilon * rho * num_particles) * (
        sigma**12 / (10.0 * r_cut**10) - sigma**6 / (4.0 * r_cut**4)
    )


def tail_correction_pressure_2d(rho: float, r_cut: float,
                                epsilon: float = 1.0,
                                sigma: float = 1.0) -> float:
    """2D LJ pressure tail correction; reference ``potential.py:48-53``."""
    return (24.0 * jnp.pi * epsilon * rho**2) * (
        sigma**12 / (5.0 * r_cut**10) - sigma**6 / (4.0 * r_cut**4)
    )


def _well_centers(box_size_x: float, box_size_y: float,
                  num_wells: int) -> jnp.ndarray:
    """Well centers at (Lx/4, Ly/2) and (3Lx/4, Ly/2); ref potential.py:88-94."""
    centers = []
    if num_wells >= 1:
        centers.append((box_size_x / 4.0, box_size_y / 2.0))
    if num_wells == 2:
        centers.append((3.0 * box_size_x / 4.0, box_size_y / 2.0))
    return jnp.asarray(centers, dtype=jnp.float32)


def double_well_potential(
    position: jnp.ndarray,
    box_size_x: float,
    box_size_y: float,
    V0_list: Sequence[float] | None = None,
    r0: float = 1.0,
    k: float = 10.0,
    num_wells: int = 2,
) -> jnp.ndarray:
    """Tanh-profile flat-bottom multi-well external potential.

    Reference ``potential.py:55-116``: for each well i,
    ``V += V0_i * (1 - 0.5*(1 + tanh(k*(r_i - r0))))`` with min-image PBC on
    the displacement to the well center (``potential.py:102-104``).

    Args:
      position: (..., 2) positions (any leading batch dims; a single (2,)
        position is also accepted).
    Returns:
      Potential with shape ``position.shape[:-1]``.
    """
    if V0_list is None:
        V0_list = [-4.0] * num_wells
    pos = jnp.asarray(position)
    squeeze = pos.ndim == 1
    if squeeze:
        pos = pos[None, :]

    centers = _well_centers(box_size_x, box_size_y, num_wells)  # (W, 2)
    sizes = jnp.asarray([box_size_x, box_size_y], dtype=pos.dtype)
    v0 = jnp.asarray(V0_list, dtype=pos.dtype)[: num_wells]

    d = pos[..., None, :] - centers  # (..., W, 2)
    d = d - sizes * jnp.round(d / sizes)
    r = jnp.sqrt(jnp.sum(d * d, axis=-1))  # (..., W)
    transition = 0.5 * (1.0 + jnp.tanh(k * (r - r0)))
    V = jnp.sum(v0 * (1.0 - transition), axis=-1)
    return V[0] if squeeze else V


def double_well_potential_equal(
    position: jnp.ndarray,
    box_size_x: float,
    box_size_y: float,
    V0: float = -2.0,
    r0: float = 1.0,
    k: float = 10.0,
    num_wells: int = 2,
) -> jnp.ndarray:
    """Equal-depth legacy variant; reference ``potential.py:120-185``."""
    return double_well_potential(position, box_size_x, box_size_y,
                                 V0_list=[V0] * num_wells, r0=r0, k=k,
                                 num_wells=num_wells)


def gaussian_double_well(
    position: jnp.ndarray,
    box_size_x: float,
    box_size_y: float,
    V0: float = -0.5,
    a: float = 5.0,
    num_wells: int = 2,
) -> jnp.ndarray:
    """Legacy Gaussian-well external potential; reference ``potential.py:187-223``.

    ``V += V0 * exp(-a * r^2)`` per well, with min-image PBC.
    """
    pos = jnp.asarray(position)
    squeeze = pos.ndim == 1
    if squeeze:
        pos = pos[None, :]
    centers = _well_centers(box_size_x, box_size_y, num_wells)
    sizes = jnp.asarray([box_size_x, box_size_y], dtype=pos.dtype)
    d = pos[..., None, :] - centers
    d = d - sizes * jnp.round(d / sizes)
    r_sq = jnp.sum(d * d, axis=-1)
    V = jnp.sum(V0 * jnp.exp(-a * r_sq), axis=-1)
    return V[0] if squeeze else V
