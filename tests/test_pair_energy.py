"""Tests for the system energy kernels vs brute-force references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.mcmc import initialise_fcc
from flowstate.ops import (
    Box, SystemSpec, particle_energy_virial, pressure, total_energy_virial,
)


def _brute_force_energy(pos, box, spec):
    """Independent numpy oracle following energy_calculator.py:121-203."""
    n = len(pos)
    e_tot, w_tot = 0.0, 0.0
    for i in range(n - 1):
        for j in range(i + 1, n):
            d = pos[i] - pos[j]
            d[0] -= box.size_x * np.round(d[0] / box.size_x)
            d[1] -= box.size_y * np.round(d[1] / box.size_y)
            r = np.hypot(d[0], d[1])
            if r < 0.5:
                return np.inf, np.inf
            if r <= 2.5:
                sr6 = r**-6
                sr12 = sr6 * sr6
                shift = 4 * (2.5**-12 - 2.5**-6)
                e_tot += 4 * (sr12 - sr6) - shift
                w_tot += 48 * (sr12 - 0.5 * sr6)
    if spec.num_wells:
        centers = [(box.size_x / 4, box.size_y / 2),
                   (3 * box.size_x / 4, box.size_y / 2)][: spec.num_wells]
        for p in pos:
            for v0, c in zip(spec.V0_list, centers):
                d = np.array([p[0] - c[0], p[1] - c[1]])
                d[0] -= box.size_x * np.round(d[0] / box.size_x)
                d[1] -= box.size_y * np.round(d[1] / box.size_y)
                r = np.hypot(d[0], d[1])
                e_tot += v0 * (1 - 0.5 * (1 + np.tanh(spec.k * (r - spec.r0))))
    return e_tot, w_tot


def _spec(n=3, wells=2):
    box = Box.from_density(n, 0.03, 1.0)
    return SystemSpec.create(n, box, num_wells=wells,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def test_total_energy_matches_brute_force(rng):
    spec = _spec()
    for _ in range(20):
        pos = rng.uniform(0, spec.box.size_x, size=(3, 2))
        e_ref, w_ref = _brute_force_energy(pos.copy(), spec.box, spec)
        e, w = total_energy_virial(spec, jnp.asarray(pos))
        if np.isinf(e_ref):
            assert np.isinf(float(e))
        else:
            np.testing.assert_allclose(float(e), e_ref, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(float(w), w_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [3, 100, 300])
def test_total_energy_matches_brute_force_dense(rng, n):
    """Dense lattice systems up to N=300 (many pairs inside the cutoff)."""
    pos, box = initialise_fcc(n, 0.3, 1.0)
    spec = SystemSpec.create(n, box, num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0)
    # jitter the lattice; the spacing keeps particles out of the hard core
    pos = pos + rng.uniform(-0.05, 0.05, size=pos.shape)
    e_ref, w_ref = _brute_force_energy(np.array(pos, np.float64), box, spec)
    e, w = total_energy_virial(spec, jnp.asarray(pos, jnp.float32))
    np.testing.assert_allclose(float(e), e_ref, rtol=2e-4, atol=1e-2)
    np.testing.assert_allclose(float(w), w_ref, rtol=2e-4, atol=1e-2)


def test_hard_core_gives_inf_many_particles(rng):
    box = Box.from_density(10, 0.3, 1.0)
    spec = SystemSpec.create(10, box, num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0)
    pos = rng.uniform(1, 5, size=(10, 2))
    pos[1] = pos[0] + 0.1  # overlap
    assert np.isinf(_brute_force_energy(pos.copy(), box, spec)[0])
    e, w = total_energy_virial(spec, jnp.asarray(pos))
    assert np.isinf(float(e)) and np.isinf(float(w))


def test_hard_core_gives_inf():
    spec = _spec()
    pos = jnp.array([[1.0, 1.0], [1.2, 1.0], [5.0, 5.0]])  # r=0.2 < 0.5
    e, w = total_energy_virial(spec, pos)
    assert np.isinf(float(e)) and np.isinf(float(w))
    ep, wp = particle_energy_virial(spec, pos, jnp.asarray(0))
    assert np.isinf(float(ep))


def test_particle_energy_consistency(rng):
    """Sum over particles of pair part = 2 * total pair energy; and the
    per-particle delta equals the total delta for a single-particle move."""
    spec = _spec()
    pos = jnp.asarray([[2.5, 5.0], [3.6, 5.4], [7.5, 5.0]])
    e_tot, _ = total_energy_virial(spec, pos)

    # move particle 1 a little; delta from per-particle energies must match
    new_pos = pos.at[1].add(jnp.asarray([0.3, -0.2]))
    e_tot_new, _ = total_energy_virial(spec, new_pos)
    e_old, _ = particle_energy_virial(spec, pos, jnp.asarray(1))
    e_new, _ = particle_energy_virial(spec, new_pos, jnp.asarray(1))
    np.testing.assert_allclose(float(e_tot_new - e_tot),
                               float(e_new - e_old), rtol=1e-3, atol=1e-4)


def test_vmap_over_chains(rng):
    spec = _spec()
    pos = jnp.asarray(rng.uniform(1, 9, size=(16, 3, 2)))
    e, w = jax.vmap(lambda p: total_energy_virial(spec, p))(pos)
    assert e.shape == (16,) and w.shape == (16,)
    e0, _ = total_energy_virial(spec, pos[0])
    np.testing.assert_allclose(float(e[0]), float(e0), rtol=1e-6)


def test_pressure_formula():
    spec = _spec()
    p = float(pressure(spec, jnp.asarray(12.0), beta=1.0))
    rho = 3 / spec.box.volume
    np.testing.assert_allclose(p, rho + 12.0 / (2 * spec.box.volume), rtol=1e-6)


def test_jit_compiles():
    spec = _spec()
    f = jax.jit(lambda p: total_energy_virial(spec, p))
    pos = jnp.asarray([[2.5, 5.0], [3.6, 5.4], [7.5, 5.0]])
    e1, _ = f(pos)
    e2, _ = total_energy_virial(spec, pos)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-6)
