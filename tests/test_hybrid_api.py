"""Direct API tests for the hybrid coupling layer (mcmc/hybrid.py).

Covers the pieces not exercised by the statistical regression test in
test_hybrid_correctness.py: the frame conversions (reference shuttles
±HALF_BOX at main_algorithm_1.py:253, 336), the batched ``nf_big_moves``
entry (monte_carlo.py:235-303) including its energy/counter bookkeeping and
key hygiene, and the judge helpers (monte_carlo.py:305-370).
"""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    bulk_judge_flow, init_chain_state, judge_flow, nf_big_moves,
)
from flowstate.mcmc.hybrid import to_box_frame, to_centered
from flowstate.ops import Box, SystemSpec, total_energy_virial


def _spec(n=3, rho=0.03):
    box = Box.from_density(n, rho, 1.0)
    return SystemSpec.create(n, box, num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0), box


def _valid_positions(key, c, n, L):
    """Well-separated configs on a jittered grid (no hard-core overlaps)."""
    g = int(np.ceil(np.sqrt(n)))
    cell = L / g
    grid = jnp.stack(jnp.meshgrid(jnp.arange(g), jnp.arange(g),
                                  indexing="ij"), -1).reshape(-1, 2)[:n]
    base = (grid + 0.5) * cell
    jit_ = jax.random.uniform(key, (c, n, 2), minval=-0.2, maxval=0.2)
    return base[None] + jit_


def test_frame_roundtrip():
    spec, box = _spec()
    half_box = float(box.size_x) / 2
    pos = _valid_positions(jax.random.key(0), 5, 3, float(box.size_x))
    flat = to_centered(pos, half_box)
    assert flat.shape == (5, 6)
    # centered frame is [-L/2, L/2)
    assert float(jnp.max(jnp.abs(flat))) <= half_box
    back = to_box_frame(flat, 3, half_box)
    np.testing.assert_allclose(np.asarray(back), np.asarray(pos), rtol=1e-6)


def test_nf_big_moves_bookkeeping():
    """Accepted chains carry the proposal's recomputed energy; rejected
    chains are bit-identical to before; counters and keys advance."""
    spec, box = _spec()
    half_box = float(box.size_x) / 2
    c = 16
    model = build_circular_flow(3, 2, half_box, K=2, hidden_units=16,
                                num_bins=4, num_blocks=1)
    params = model.init_params(jax.random.key(0))
    pos0 = _valid_positions(jax.random.key(1), c, 3, float(box.size_x))
    state = init_chain_state(spec, pos0, jax.random.key(2), 0.5)

    res = jax.jit(lambda s: nf_big_moves(spec, 1.0, s, model, params,
                                         half_box))(state)
    new = res.state
    accepted = np.asarray(res.accepted)
    assert accepted.dtype == bool and accepted.shape == (c,)

    # energy bookkeeping: stored energy == fresh recompute of positions
    e_re, v_re = jax.vmap(lambda p: total_energy_virial(spec, p))(
        new.positions)
    np.testing.assert_allclose(np.asarray(new.energy), np.asarray(e_re),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(new.virial), np.asarray(v_re),
                               rtol=1e-4, atol=1e-4)

    # rejected chains are untouched; accepted chains moved
    moved = np.any(np.asarray(new.positions != state.positions), axis=(1, 2))
    np.testing.assert_array_equal(moved, accepted)

    # counters: one attempt each, accepts incremented where accepted
    np.testing.assert_array_equal(np.asarray(new.attempts),
                                  np.asarray(state.attempts) + 1)
    np.testing.assert_array_equal(
        np.asarray(new.accepts),
        np.asarray(state.accepts) + accepted.astype(np.int32))

    # key hygiene: every chain's key stream advanced
    assert not np.any(np.asarray(
        jax.random.key_data(new.key) == jax.random.key_data(state.key))
        .all(axis=-1))

    # MH ratio is finite for in-support proposals (uniform base covers box)
    assert np.all(np.isfinite(np.asarray(res.ratio_log)))


def test_nf_big_moves_deterministic_given_state():
    spec, box = _spec()
    half_box = float(box.size_x) / 2
    model = build_circular_flow(3, 2, half_box, K=2, hidden_units=16,
                                num_bins=4, num_blocks=1)
    params = model.init_params(jax.random.key(0))
    pos0 = _valid_positions(jax.random.key(1), 4, 3, float(box.size_x))
    state = init_chain_state(spec, pos0, jax.random.key(2), 0.5)
    r1 = nf_big_moves(spec, 1.0, state, model, params, half_box)
    r2 = nf_big_moves(spec, 1.0, state, model, params, half_box)
    np.testing.assert_array_equal(np.asarray(r1.state.positions),
                                  np.asarray(r2.state.positions))


def test_judge_flow_limits():
    """ΔE = 0 → always accepted; hard-core overlap (inf) → always rejected."""
    spec, box = _spec()
    c = 8
    pos0 = _valid_positions(jax.random.key(0), c, 3, float(box.size_x))
    state = init_chain_state(spec, pos0, jax.random.key(1), 0.5)

    same = judge_flow(spec, 1.0, state, state.positions, jax.random.key(2))
    assert bool(jnp.all(same))

    overlap = state.positions.at[:, 1, :].set(state.positions[:, 0, :])
    bad = judge_flow(spec, 1.0, state, overlap, jax.random.key(3))
    assert not bool(jnp.any(bad))


def test_bulk_judge_flow_limits():
    """Behavioral limits (not a re-derivation of the formula — ADVICE r1):
    ΔE = 0 → all accepted; hard-core overlap → rejected; counts add up."""
    spec, box = _spec()
    c = 32
    configs = _valid_positions(jax.random.key(0), c, 3, float(box.size_x))
    energies, _ = jax.vmap(lambda p: total_energy_virial(spec, p))(configs)

    # ΔE = 0 for every config → the Metropolis rule must accept all
    n_acc, n_att = bulk_judge_flow(spec, 1.0, configs, energies,
                                   jax.random.key(4))
    assert n_att == c and int(n_acc) == c

    # overlapping particles → inf energy → all rejected, regardless of key
    overlap = configs.at[:, 1, :].set(configs[:, 0, :])
    for seed in range(3):
        n_acc, n_att = bulk_judge_flow(spec, 1.0, overlap, energies,
                                       jax.random.key(seed))
        assert n_att == c and int(n_acc) == 0

    # mixed batch: overlap in the first half only → exactly the good half
    # can be accepted (and with ΔE <= 0 it must be)
    mixed = configs.at[: c // 2, 1, :].set(configs[: c // 2, 0, :])
    n_acc, n_att = bulk_judge_flow(spec, 1.0, mixed, energies + 100.0,
                                   jax.random.key(5))
    assert n_att == c and int(n_acc) == c // 2
