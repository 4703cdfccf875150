"""HMC sampler tests: integrator quality, bookkeeping, Boltzmann parity.

HMC is a beyond-reference capability (like MALA it uses ``jax.grad`` of
the engine's own energy; the reference's ``lennard_jones_force``,
MCMC/potential.py:38-46, is defined but never called); correctness is
pinned against the same exact-quadrature oracle as the Metropolis and
MALA engines.
"""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc import (
    init_chain_state, resync_energy, run_hmc_batch,
    run_hmc_equilibration_batch,
)
from flowstate.ops import Box, SystemSpec
from flowstate.ops.potentials import double_well_potential


def _spec_n1():
    box = Box.from_density(1, 0.01, 1.0)  # 10x10 box
    return SystemSpec.create(1, box, num_wells=2, V0_list=(-2.0, -2.5),
                             r0=1.2, k=15.0)


def _spec_n3():
    box = Box.from_density(3, 0.03, 1.0)
    return SystemSpec.create(3, box, num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0)


def test_hmc_small_eps_conserves_energy():
    """The leapfrog integrator's Hamiltonian error is O(eps^2); at a tiny
    step size acceptance must be essentially 1 even for 10-step
    trajectories on the interacting N=3 system."""
    spec = _spec_n3()
    pos = jnp.asarray(
        np.stack([[[2.1, 5.0], [3.0, 4.2], [7.6, 5.1]]] * 32))
    state = init_chain_state(spec, pos, jax.random.key(0), 1e-3)
    out = run_hmc_batch(spec, 1.0, state, 20, num_leapfrog=10)
    acc = np.asarray(out.accepts) / np.asarray(out.attempts)
    assert float(acc.mean()) > 0.98, float(acc.mean())


def test_hmc_bookkeeping_exact():
    """Energies/virials are recomputed per move — tracked totals must equal
    a fresh resync exactly (no fp drift accumulation)."""
    spec = _spec_n3()
    pos = jnp.asarray(
        np.stack([[[2.1, 5.0], [3.0, 4.2], [7.6, 5.1]]] * 8))
    state = init_chain_state(spec, pos, jax.random.key(1), 0.02)
    out = run_hmc_batch(spec, 1.0, state, 40, num_leapfrog=5)
    res = resync_energy(spec, out)
    np.testing.assert_allclose(np.asarray(out.energy),
                               np.asarray(res.energy), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.virial),
                               np.asarray(res.virial), rtol=1e-6, atol=1e-4)
    assert np.all(np.asarray(out.attempts) == 40)
    assert np.all(np.isfinite(np.asarray(out.positions)))
    # positions stay wrapped
    assert np.all(np.asarray(out.positions) >= 0)
    assert np.all(np.asarray(out.positions) <= float(spec.box.size_x))


def test_eps_adaptation_recovers_healthy_acceptance():
    """With an absurd step size (whole-trajectory teleports -> LJ clashes)
    acceptance collapses; adaptation must shrink eps until a fresh
    segment accepts at a healthy rate."""
    spec = _spec_n3()
    pos = jnp.asarray(
        np.stack([[[2.1, 5.0], [3.0, 4.2], [7.6, 5.1]]] * 64))
    state = init_chain_state(spec, pos, jax.random.key(2), 1.0)
    out = run_hmc_equilibration_batch(spec, 1.0, state, 400, 50,
                                      num_leapfrog=5)
    eps = np.asarray(out.max_disp)
    assert np.all(eps < 1.0)
    out2 = run_hmc_batch(spec, 1.0, out, 150, num_leapfrog=5)
    acc = (np.asarray(out2.accepts - out.accepts)
           / np.asarray(out2.attempts - out.attempts))
    assert 0.2 < float(acc.mean()) < 0.98, float(acc.mean())


def test_hmc_single_particle_boltzmann_free_energy():
    """Same exact-quadrature oracle as the Metropolis/MALA engines: the
    HMC chains' well occupancies must reproduce ln(Z_B/Z_A)."""
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
    state = run_hmc_equilibration_batch(spec, beta, state, 200, 25,
                                        num_leapfrog=5)

    # production: fixed eps, sample every 3 trajectories
    frames = []
    for _ in range(80):
        state = run_hmc_batch(spec, beta, state, 3, num_leapfrog=5)
        frames.append(np.asarray(state.positions))
    xy = np.concatenate(frames).reshape(-1, 2)

    in_A = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    in_B = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    sampled_dF = np.log(in_B.sum() / in_A.sum())
    assert abs(sampled_dF - exact_dF) < 0.15, (sampled_dF, exact_dF)
