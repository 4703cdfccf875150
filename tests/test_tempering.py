"""Parallel-tempering tests: swap formula, bookkeeping, cold-marginal physics.

Capability extension beyond the reference (SURVEY.md: the reference's only
rare-event machinery is the NF big move); validated against the same exact
quadrature oracle as the plain engine.
"""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc import (
    init_tempered_state, resync_energy, run_replica_exchange,
    run_tempered_moves, swap_replicas, temperature_ladder,
)
from flowstate.ops import Box, SystemSpec
from flowstate.ops.potentials import double_well_potential


def _spec_deep_n1():
    """Single particle, 6 kT asymmetric double well (barrier too deep for
    plain beta=1 sampling to cross reliably)."""
    box = Box.from_density(1, 0.01, 1.0)  # 10x10
    return SystemSpec.create(1, box, num_wells=2, V0_list=(-6.0, -6.5),
                             r0=1.2, k=15.0)


def _tempered_state(spec, r, w, key=0, x0=None):
    lx, ly = spec.box.size_x, spec.box.size_y
    pos = np.tile(np.asarray(x0 if x0 is not None
                             else [lx / 4, ly / 2], dtype=np.float32),
                  (r, w, spec.num_particles, 1))
    return init_tempered_state(spec, jnp.asarray(pos), jax.random.key(key),
                               1.5)


def test_temperature_ladder():
    betas = temperature_ladder(1.0, 8.0, 4)
    np.testing.assert_allclose(np.asarray(betas)[0], 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(betas)[-1], 0.125, rtol=1e-6)
    assert np.all(np.diff(np.asarray(betas)) < 0)  # monotone cooling->heating
    lin = temperature_ladder(1.0, 3.0, 3, kind="linear")
    np.testing.assert_allclose(np.asarray(lin), [1.0, 0.5, 1 / 3], rtol=1e-6)
    for bad in [("geometric", 1), ("nope", 3)]:
        try:
            temperature_ladder(1.0, 2.0, bad[1], kind=bad[0])
            raise AssertionError("expected ValueError")
        except ValueError:
            pass


def test_swap_acceptance_matches_formula():
    """Empirical swap rate equals min(1, exp((b_i - b_j)(E_i - E_j)))."""
    spec = _spec_deep_n1()
    w = 8192
    betas = jnp.asarray([1.0, 0.5])
    state = _tempered_state(spec, 2, w)
    # pin the cached energies: E_cold - E_hot = -2  ->  log-ratio = -1
    e = jnp.stack([jnp.full((w,), -5.0), jnp.full((w,), -3.0)])
    state = state._replace(energy=e)
    res = swap_replicas(betas, state, jax.random.key(1), parity=0)
    rate = float(jnp.mean(res.accepted[0].astype(jnp.float32)))
    expected = np.exp(-1.0)
    assert abs(rate - expected) < 4 * np.sqrt(expected / w), (rate, expected)
    # both members of every pair agree, and accepted walkers really swapped
    np.testing.assert_array_equal(np.asarray(res.accepted[0]),
                                  np.asarray(res.accepted[1]))
    acc = np.asarray(res.accepted[0])
    np.testing.assert_allclose(np.asarray(res.state.energy[0])[acc], -3.0)
    np.testing.assert_allclose(np.asarray(res.state.energy[0])[~acc], -5.0)


def test_swap_parity_pairing_and_edge_accounting():
    spec = _spec_deep_n1()
    betas = temperature_ladder(1.0, 4.0, 5)
    state = _tempered_state(spec, 5, 3)
    res0 = swap_replicas(betas, state, jax.random.key(2), parity=0)
    # parity 0: edges (0,1), (2,3) active; (1,2), (3,4) not
    np.testing.assert_array_equal(np.asarray(res0.edge_attempted)[:-1],
                                  [True, False, True, False])
    res1 = swap_replicas(betas, state, jax.random.key(3), parity=1)
    np.testing.assert_array_equal(np.asarray(res1.edge_attempted)[:-1],
                                  [False, True, False, True])


def test_swap_preserves_energy_multiset_and_cache():
    spec = _spec_deep_n1()
    betas = temperature_ladder(1.0, 4.0, 4)
    state = _tempered_state(spec, 4, 16)
    state = run_tempered_moves(spec, betas, state, 200)
    res = swap_replicas(betas, state, jax.random.key(4), parity=0)
    # per walker, the multiset of replica energies is conserved
    np.testing.assert_allclose(
        np.sort(np.asarray(state.energy), axis=0),
        np.sort(np.asarray(res.state.energy), axis=0), atol=1e-5)
    # swapped caches stay consistent with a full recompute
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), res.state)
    resynced = resync_energy(spec, flat)
    np.testing.assert_allclose(np.asarray(flat.energy),
                               np.asarray(resynced.energy), atol=1e-3)


def test_replica_exchange_cold_marginal_matches_quadrature():
    """All walkers start in well A; the PT cold marginal must still find the
    exact occupancy ratio (hot replicas cross, exchanges transport)."""
    spec = _spec_deep_n1()
    beta = 1.0
    lx, ly = spec.box.size_x, spec.box.size_y

    # exact via quadrature (as tests/test_mcmc.py oracle)
    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1))
    V = np.asarray(double_well_potential(pts, lx, ly,
                                         V0_list=list(spec.V0_list),
                                         r0=spec.r0, k=spec.k)).reshape(g, g)
    wgt = np.exp(-beta * V)
    radius = 1.1 * spec.r0
    dA = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    dB = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    exact_dF = np.log(wgt[dB].sum() / wgt[dA].sum())

    betas = temperature_ladder(1.0, 6.0, 4)
    state = _tempered_state(spec, 4, 64, key=5)  # ALL in well A

    run = jax.jit(lambda s, k: run_replica_exchange(
        spec, betas, s, k, num_rounds=400, moves_per_round=25))
    result = run(state, jax.random.key(6))

    acc = np.asarray(result.edge_acceptance)
    assert np.all(acc > 0.05), acc  # the geometric ladder overlaps

    cold = np.asarray(result.cold_positions)[200:]  # (T, W, 1, 2), burn-in cut
    xy = cold.reshape(-1, 2)
    in_A = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    in_B = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius
    assert in_B.sum() > 0, "cold replica never reached well B"
    sampled_dF = np.log(in_B.sum() / in_A.sum())
    assert abs(sampled_dF - exact_dF) < 0.3, (sampled_dF, exact_dF)
