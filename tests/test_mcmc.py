"""Tests for the batched Metropolis engine.

Statistical parity is asserted against exact Boltzmann quadrature (a
stronger oracle than the reference, which has zero automated MCMC tests —
SURVEY.md §4): a single particle in the asymmetric double well must
reproduce the exact well free-energy difference within MC error.
"""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc import (
    ChainState, adjust_displacement, init_alternating_wells, init_chain_state,
    initialise_fcc, initialise_low_left, initialise_low_right, resync_energy,
    run_equilibration_batch, run_moves_batch, run_production_batch,
)
from flowstate.ops import Box, SystemSpec
from helpers.oracles import (
    exact_well_delta_f, sampled_well_delta_f, single_particle_spec,
    split_start,
)


def _spec_n3():
    box = Box.from_density(3, 0.03, 1.0)
    return SystemSpec.create(3, box, num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0)


def test_initialisers():
    p, box = initialise_low_left(3, 0.03, 1.0)
    assert p.shape == (3, 2) and np.isclose(box.size_x, 10.0)
    assert np.all(p[:, 0] < box.size_x / 2)  # on the left
    p2, _ = initialise_low_right(3, 0.03, 1.0)
    assert np.all(p2[:, 0] > box.size_x / 2)
    pf, boxf = initialise_fcc(48, 0.5, 1.5)
    assert pf.shape == (48, 2)
    # lattice spacing must exceed the hard core
    from flowstate.ops import pair_distance_matrix
    dm = np.array(pair_distance_matrix(jnp.asarray(pf), boxf))
    np.fill_diagonal(dm, 10.0)
    assert dm.min() > 0.5

    batch, _ = init_alternating_wells(4, 3, 0.03)
    assert batch.shape == (4, 3, 2)
    assert np.all(batch[0][:, 0] < 5.0) and np.all(batch[1][:, 0] > 5.0)


def test_deterministic_given_key():
    spec = _spec_n3()
    pos, _ = init_alternating_wells(4, 3, 0.03)
    s0 = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0), 0.65)
    a = run_moves_batch(spec, 1.0, s0, 50)
    b = run_moves_batch(spec, 1.0, s0, 50)
    np.testing.assert_array_equal(np.asarray(a.positions),
                                  np.asarray(b.positions))


def test_energy_bookkeeping_consistency():
    """Cached (delta-updated) energy must match a full recompute."""
    spec = _spec_n3()
    pos, _ = init_alternating_wells(8, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(1), 0.65)
    state = run_moves_batch(spec, 1.0, state, 500)
    resynced = resync_energy(spec, state)
    np.testing.assert_allclose(np.asarray(state.energy),
                               np.asarray(resynced.energy),
                               rtol=1e-4, atol=1e-3)
    assert np.all(np.isfinite(np.asarray(state.energy)))


def test_batched_energy_chunking_matches_vmap():
    """batched_energy_virial's lax.map chunking (the large-C*N^2 OOM
    guard) must reproduce the full vmap exactly."""
    from flowstate.mcmc.state import batched_energy_virial

    spec = _spec_n3()
    pos, _ = init_alternating_wells(11, 3, 0.03)
    pos = jnp.asarray(pos)
    e_full, v_full = batched_energy_virial(spec, pos)          # vmap path
    # chunk_elems small enough to force 3-chain chunks with padding
    e_chunk, v_chunk = batched_energy_virial(spec, pos,
                                             chunk_elems=3 * 3 * 3 * 2)
    # not bitwise: XLA orders the pair reductions differently in the two
    # program shapes; agreement is to float32 reduction-order noise
    np.testing.assert_allclose(np.asarray(e_full), np.asarray(e_chunk),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v_full), np.asarray(v_chunk),
                               rtol=1e-5, atol=1e-5)


def test_hard_core_never_violated():
    spec = _spec_n3()
    pos, _ = init_alternating_wells(8, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(2), 0.65)
    state, obs = run_production_batch(spec, 1.0, state, 20, 50)
    configs = np.asarray(obs.positions).reshape(-1, 3, 2)  # (C*T, N, 2)
    from flowstate.ops import pair_distance_matrix
    for cfg in configs[:50]:
        dm = np.array(pair_distance_matrix(jnp.asarray(cfg), spec.box))
        np.fill_diagonal(dm, 10.0)
        assert dm.min() >= 0.5


def test_adjust_displacement_formula():
    spec = _spec_n3()
    state = ChainState(
        positions=jnp.zeros((2, 3, 2)), energy=jnp.zeros(2),
        virial=jnp.zeros(2), max_disp=jnp.asarray([0.5, 0.5]),
        attempts=jnp.asarray([100, 100], dtype=jnp.int32),
        accepts=jnp.asarray([80, 10], dtype=jnp.int32),
        prev_attempts=jnp.zeros(2, dtype=jnp.int32),
        prev_accepts=jnp.zeros(2, dtype=jnp.int32),
        key=jax.random.split(jax.random.key(0), 2))
    out = jax.vmap(adjust_displacement)(state)
    # chain 0: frac 0.8 / 0.5 = 1.6 -> clamp 1.5 -> 0.75
    # chain 1: frac 0.1 / 0.5 = 0.2 -> clamp 0.5 -> 0.25
    np.testing.assert_allclose(np.asarray(out.max_disp), [0.75, 0.25],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.prev_attempts), [100, 100])


def test_equilibration_adapts_displacement():
    spec = _spec_n3()
    pos, _ = init_alternating_wells(4, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(3), 0.65)
    out = run_equilibration_batch(spec, 1.0, state, 600, 200)
    assert np.all(np.asarray(out.attempts) == 600)
    # displacement was adapted (3 adjustment events happened)
    assert not np.allclose(np.asarray(out.max_disp), 0.65)


def test_single_particle_boltzmann_free_energy():
    """ΔF = ln(P_B/P_A) from sampling must match exact quadrature.

    This is the well-occupancy observable of the reference
    (hybrid_NF_MCMC/utils.py:61-101) validated against the analytically
    integrable N=1 system.
    """
    spec = single_particle_spec()
    beta = 1.0
    exact_dF = exact_well_delta_f(spec, beta)

    # sample: 256 chains x 600 samples at stride 5
    state = init_chain_state(spec, jnp.asarray(split_start(spec, 256)),
                             jax.random.key(7), 1.5)
    state = run_moves_batch(spec, beta, state, 300)  # equilibrate
    state, obs = run_production_batch(spec, beta, state, 600, 5)
    sampled_dF = sampled_well_delta_f(spec, obs.positions)

    # MC error at ~1.5e5 correlated samples: allow a generous band
    assert abs(sampled_dF - exact_dF) < 0.12, (sampled_dF, exact_dF)


def test_acceptance_rate_reasonable():
    spec = _spec_n3()
    pos, _ = init_alternating_wells(16, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(5), 0.65)
    state = run_moves_batch(spec, 1.0, state, 1000)
    frac = np.asarray(state.accepts) / np.asarray(state.attempts)
    assert np.all(frac > 0.2) and np.all(frac < 0.98)
