"""MALA sampler tests: gradient correctness, bookkeeping, Boltzmann parity.

MALA is a beyond-reference capability (the reference's
``lennard_jones_force``, MCMC/potential.py:38-46, is defined but never
called); correctness is pinned against the same exact-quadrature oracle as
the Metropolis engine (tests/test_mcmc.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc import (
    adjust_tau, init_chain_state, potential_gradient, run_mala,
    run_mala_batch, run_mala_equilibration_batch, resync_energy,
)
from flowstate.ops import Box, SystemSpec
from flowstate.ops.pair_energy import total_energy_virial
from flowstate.ops.potentials import double_well_potential


def _spec_n1():
    box = Box.from_density(1, 0.01, 1.0)  # 10x10 box
    return SystemSpec.create(1, box, num_wells=2, V0_list=(-2.0, -2.5),
                             r0=1.2, k=15.0)


def _spec_n3():
    box = Box.from_density(3, 0.03, 1.0)
    return SystemSpec.create(3, box, num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0)


def test_potential_gradient_matches_finite_differences():
    spec = _spec_n3()
    pos = jnp.asarray([[2.1, 5.0], [3.0, 4.2], [7.6, 5.1]])
    g = np.asarray(potential_gradient(spec, pos))
    eps = 1e-4
    for i in range(3):
        for d in range(2):
            p_plus = pos.at[i, d].add(eps)
            p_minus = pos.at[i, d].add(-eps)
            fd = (float(total_energy_virial(spec, p_plus)[0])
                  - float(total_energy_virial(spec, p_minus)[0])) / (2 * eps)
            assert abs(fd - g[i, d]) < 5e-2 * max(1.0, abs(fd)), (i, d)


def test_gradient_finite_even_on_overlap():
    spec = _spec_n3()
    pos = jnp.asarray([[5.0, 5.0], [5.1, 5.0], [8.0, 2.0]])  # r=0.1 overlap
    g = np.asarray(potential_gradient(spec, pos))
    assert np.all(np.isfinite(g))


def test_mala_bookkeeping_exact():
    """Energies/virials are recomputed per move — tracked totals must equal
    a fresh resync exactly (no fp drift accumulation)."""
    spec = _spec_n3()
    pos = jnp.asarray(
        np.stack([[[2.1, 5.0], [3.0, 4.2], [7.6, 5.1]]] * 8))
    state = init_chain_state(spec, pos, jax.random.key(0), 0.02)
    out = run_mala_batch(spec, 1.0, state, 50)
    res = resync_energy(spec, out)
    np.testing.assert_allclose(np.asarray(out.energy),
                               np.asarray(res.energy), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.virial),
                               np.asarray(res.virial), rtol=1e-6, atol=1e-4)
    assert np.all(np.asarray(out.attempts) == 50)
    assert np.all(np.isfinite(np.asarray(out.positions)))
    # positions stay wrapped
    assert np.all(np.asarray(out.positions) >= 0)
    assert np.all(np.asarray(out.positions) <= float(spec.box.size_x))


def test_tau_adaptation_targets_mala_optimum():
    """With an absurd step size on the interacting N=3 system (random
    3-particle teleports -> LJ clashes) acceptance collapses; adaptation
    must shrink tau until a fresh segment accepts at a healthy rate."""
    spec = _spec_n3()
    pos = jnp.asarray(
        np.stack([[[2.1, 5.0], [3.0, 4.2], [7.6, 5.1]]] * 64))
    state = init_chain_state(spec, pos, jax.random.key(1), 2.0)
    out = run_mala_equilibration_batch(spec, 1.0, state, 600, 50)
    tau = np.asarray(out.max_disp)
    assert np.all(tau < 2.0)
    # after adaptation a fresh segment accepts at a healthy rate
    out2 = run_mala_batch(spec, 1.0, out, 200)
    acc = (np.asarray(out2.accepts - out.accepts)
           / np.asarray(out2.attempts - out.attempts))
    assert 0.2 < float(acc.mean()) < 0.95, float(acc.mean())


def test_mala_single_particle_boltzmann_free_energy():
    """Same exact-quadrature oracle as the Metropolis engine: the MALA
    chain's well occupancies must reproduce ln(Z_B/Z_A)."""
    spec = _spec_n1()
    beta = 1.0
    lx, ly = spec.box.size_x, spec.box.size_y

    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1))
    V = np.asarray(double_well_potential(pts, lx, ly,
                                         V0_list=list(spec.V0_list),
                                         r0=spec.r0, k=spec.k)).reshape(g, g)
    w = np.exp(-beta * V)
    radius = 1.1 * spec.r0
    dA = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    dB = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    exact_dF = np.log(w[dB].sum() / w[dA].sum())

    c = 256
    pos0 = np.tile(np.array([[lx / 4, ly / 2]]), (c, 1, 1))
    pos0[c // 2:, :, 0] = 3 * lx / 4
    state = init_chain_state(spec, jnp.asarray(pos0), jax.random.key(7), 0.3)
    state = run_mala_equilibration_batch(spec, beta, state, 300, 50)

    # production: fixed tau, sample every 5 moves
    frames = []
    for _ in range(120):
        state = run_mala_batch(spec, beta, state, 5)
        frames.append(np.asarray(state.positions))
    xy = np.concatenate(frames).reshape(-1, 2)

    in_A = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    in_B = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    sampled_dF = np.log(in_B.sum() / in_A.sum())
    assert abs(sampled_dF - exact_dF) < 0.12, (sampled_dF, exact_dF)
