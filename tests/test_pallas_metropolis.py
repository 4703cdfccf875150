"""Triton Metropolis move-kernel tests.

On the CPU the kernel runs in Pallas interpret mode, where its counter-based
generator draws the same numbers as on the card, so the statistics are
tested here: the generator itself, the bookkeeping, agreement with the
plain engine, and the exact-quadrature oracle.  Tests marked ``gpu`` run the
kernel as compiled for the card; they skip elsewhere and are run by phase d
of ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.random import threefry_2x32
from scipy import stats

import flowstate.mcmc.pallas_metropolis as pm
from flowstate.mcmc import (
    init_alternating_wells, init_chain_state, resync_energy, run_moves_batch,
)
from flowstate.mcmc.pallas_metropolis import (
    BLOCK_C, MAX_PARTICLES, move_randoms, run_moves_auto, run_moves_pallas,
    threefry2x32,
)
from flowstate.ops import Box, SystemSpec
from helpers.oracles import (
    exact_well_delta_f, sampled_well_delta_f, single_particle_spec,
    split_start,
)


def _spec_n3():
    return SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def _state_n3(chains, seed=0):
    spec = _spec_n3()
    pos, _ = init_alternating_wells(chains, 3, 0.03)
    return spec, init_chain_state(spec, jnp.asarray(pos),
                                  jax.random.key(seed), 0.65)


def _interpret(monkeypatch):
    """Route the kernel's callers through interpret mode."""
    monkeypatch.setattr(pm, "run_moves_pallas", functools.partial(
        run_moves_pallas, interpret=True))


def _require_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "path (chip_smoke.py runs this test on the card)")


@pytest.mark.parametrize("prop", ["matches_jax_threefry", "uniform",
                                  "distinct_streams", "deterministic"])
def test_counter_generator(prop):
    """The in-kernel Threefry-2x32 generator."""
    k0, k1 = jnp.uint32(0x12345678), jnp.uint32(0x9ABCDEF0)
    chains = jnp.arange(4096, dtype=jnp.uint32)
    if prop == "matches_jax_threefry":
        ctr = jnp.arange(64, dtype=jnp.uint32)
        a, b = threefry2x32(k0, k1, ctr, ctr + 1000)
        ref = threefry_2x32(jnp.stack([k0, k1]),
                            jnp.concatenate([ctr, ctr + 1000]))
        np.testing.assert_array_equal(np.concatenate([a, b]), ref)
    elif prop == "uniform":
        _, u1, u2, ua = move_randoms(k0, k1, chains, jnp.int32(3))
        for u in (u1, u2, ua):
            u = np.asarray(u, np.float64)
            assert np.all((u >= 0) & (u < 1))
            assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / u.size)
            assert abs(u.var() - 1 / 12) < 0.01
            assert stats.kstest(u, "uniform").pvalue > 1e-3
        # the three uniforms of one move are uncorrelated
        corr = np.corrcoef(np.stack([u1, u2, ua]))[np.triu_indices(3, 1)]
        assert np.abs(corr).max() < 0.06
    elif prop == "distinct_streams":
        w_move0 = np.asarray(move_randoms(k0, k1, chains, jnp.int32(0))[0])
        w_move1 = np.asarray(move_randoms(k0, k1, chains, jnp.int32(1))[0])
        w_key2 = np.asarray(move_randoms(k0 + jnp.uint32(1), k1, chains,
                                         jnp.int32(0))[0])
        assert len(np.unique(w_move0)) == chains.size      # across chains
        assert np.mean(w_move0 == w_move1) < 1e-2          # across moves
        assert np.mean(w_move0 == w_key2) < 1e-2           # across calls
        # successive calls on an advancing state draw fresh keys
        spec, state = _state_n3(8)
        out = run_moves_pallas(spec, 1.0, state, 4, interpret=True)
        assert not np.array_equal(pm.kernel_key(state), pm.kernel_key(out))
    else:
        spec, state = _state_n3(40)
        a = run_moves_pallas(spec, 1.0, state, 30, seed=11, interpret=True)
        b = run_moves_pallas(spec, 1.0, state, 30, seed=11, interpret=True)
        c = run_moves_pallas(spec, 1.0, state, 30, seed=12, interpret=True)
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.accepts, b.accepts)
        assert not np.array_equal(a.positions, c.positions)


def test_interpret_bookkeeping_consistent():
    spec, state = _state_n3(BLOCK_C)
    out = run_moves_pallas(spec, 1.0, state, 100, seed=3, interpret=True)
    # positions stay in the box
    assert np.all(np.asarray(out.positions) >= 0)
    assert np.all(np.asarray(out.positions) <= 10.0)
    # cached energy equals a full recompute
    res = resync_energy(spec, out)
    np.testing.assert_allclose(np.asarray(out.energy),
                               np.asarray(res.energy), atol=1e-3)
    # counters advanced, and some but not all moves were accepted
    assert np.all(np.asarray(out.attempts) - np.asarray(state.attempts)
                  == 100)
    acc = np.asarray(out.accepts) - np.asarray(state.accepts)
    assert np.all((acc > 0) & (acc < 100))
    # every particle moved in some chain
    moved = np.any(np.asarray(out.positions) != np.asarray(state.positions),
                   axis=(0, 2))
    assert np.all(moved)


def test_virial_is_poisoned_until_resync():
    """The kernel does not track the virial; the returned field must be
    NaN (visibly wrong, not silently stale) until resync_energy."""
    spec, state = _state_n3(BLOCK_C)
    out = run_moves_pallas(spec, 1.0, state, 10, seed=1, interpret=True)
    assert np.all(np.isnan(np.asarray(out.virial)))
    res = resync_energy(spec, out)
    assert np.all(np.isfinite(np.asarray(res.virial)))


def test_auto_padding_of_chain_axis():
    """Chain counts that are not BLOCK_C multiples are padded by replicating
    the last chain and sliced back.  Each chain's stream is keyed by its
    index, so the real chains match a run over an unpadded batch exactly."""
    spec, state = _state_n3(2 * BLOCK_C)
    c = BLOCK_C + 5
    part = jax.tree_util.tree_map(lambda x: x[:c], state)
    out = run_moves_pallas(spec, 1.0, part, 50, seed=7, interpret=True)
    full = run_moves_pallas(spec, 1.0, state, 50, seed=7, interpret=True)
    assert out.positions.shape == (c, 3, 2)
    assert out.energy.shape == (c,)
    np.testing.assert_array_equal(out.positions, full.positions[:c])
    np.testing.assert_array_equal(out.accepts, full.accepts[:c])
    res = resync_energy(spec, out)
    np.testing.assert_allclose(np.asarray(out.energy),
                               np.asarray(res.energy), atol=1e-3)
    assert np.all(np.asarray(out.attempts) - np.asarray(part.attempts)
                  == 50)


def test_multi_sublane_particle_tiles():
    """N=12 pads the particle tile to 16 rows; the bookkeeping stays exact
    and the padded rows never act as particles."""
    n = 12
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    pos, _ = init_alternating_wells(64, n, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0), 0.65)
    out = run_moves_pallas(spec, 1.0, state, 30, seed=5, interpret=True)
    assert out.positions.shape == (64, n, 2)
    box = float(spec.box.size_x)
    assert np.all(np.asarray(out.positions) >= 0)
    assert np.all(np.asarray(out.positions) <= box)
    res = resync_energy(spec, out)
    np.testing.assert_allclose(np.asarray(out.energy),
                               np.asarray(res.energy),
                               rtol=1e-5, atol=1e-3)


def test_too_many_particles_raises_and_auto_dispatches(monkeypatch):
    """run_moves_auto: the kernel up to MAX_PARTICLES, the plain engine
    above it; run_moves_pallas refuses N > MAX_PARTICLES."""
    n = MAX_PARTICLES + 1
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=0)
    box = float(spec.box.size_x)
    side = int(np.ceil(np.sqrt(n)))
    xy = np.stack(np.meshgrid(np.arange(side), np.arange(side)),
                  -1).reshape(-1, 2)[:n] * (box / side) + box / (2 * side)
    pos = np.broadcast_to(xy, (4, n, 2)).copy()
    state = init_chain_state(spec, jnp.asarray(pos, dtype=jnp.float32),
                             jax.random.key(0), 0.65)
    with pytest.raises(ValueError, match="up to"):
        run_moves_pallas(spec, 1.0, state, 5, interpret=True)
    out = run_moves_auto(spec, 1.0, state, 5)
    assert out.positions.shape == (4, n, 2)
    assert np.all(np.asarray(out.attempts) - np.asarray(state.attempts) == 5)
    assert np.all(np.isfinite(np.asarray(out.virial)))   # plain engine

    calls = []
    monkeypatch.setattr(pm, "run_moves_pallas",
                        lambda *a, **k: calls.append(a[0].num_particles))
    spec3, state3 = _state_n3(4)
    run_moves_auto(spec3, 1.0, state3, 5)
    assert calls == [3]


def test_production_pallas_shapes_and_observables(monkeypatch):
    """run_production_pallas matches run_production_batch's observable
    layout and records exact (resynced) energies/virials."""
    from flowstate.mcmc import run_production_pallas
    from flowstate.ops import total_energy_virial

    c, t = 64, 5
    spec, state = _state_n3(c)
    _interpret(monkeypatch)
    out, obs = run_production_pallas(spec, 1.0, state, t, 10)
    assert obs.positions.shape == (c, t, 3, 2)
    assert obs.energy_per_particle.shape == (c, t)
    assert obs.cycle.shape == (c, t)
    np.testing.assert_array_equal(np.asarray(obs.cycle[0]),
                                  np.arange(1, t + 1) * 10)
    # virial resynced every block -> recorded pressure is finite
    assert np.all(np.isfinite(np.asarray(obs.pressure)))
    assert np.all(np.isfinite(np.asarray(out.virial)))
    # recorded energy is the exact recompute of the recorded positions
    e_last, _ = jax.vmap(lambda p: total_energy_virial(spec, p))(
        obs.positions[:, -1])
    np.testing.assert_allclose(np.asarray(obs.energy_per_particle[:, -1]),
                               np.asarray(e_last) / 3, rtol=1e-6)


def test_kernel_matches_exact_quadrature(monkeypatch):
    """The kernel's samples reproduce the exact single-particle well ΔF
    (the same oracle and band as the plain engine's test in test_mcmc)."""
    from flowstate.mcmc import run_production_pallas

    spec = single_particle_spec()
    state = init_chain_state(spec, jnp.asarray(split_start(spec, 256)),
                             jax.random.key(7), 1.5)
    state = run_moves_pallas(spec, 1.0, state, 300, interpret=True)
    _interpret(monkeypatch)
    _, obs = run_production_pallas(spec, 1.0, state, 600, 5)
    sampled = sampled_well_delta_f(spec, obs.positions)
    exact = exact_well_delta_f(spec, 1.0)
    assert abs(sampled - exact) < 0.12, (sampled, exact)


def _compare_with_plain_engine(chains, moves, interpret, n=3):
    """Kernel vs plain engine from one start: acceptance within 0.02, mean
    energy per particle within 3 standard errors over chains."""
    if n == 3:
        spec, state = _state_n3(chains)
    else:
        from flowstate.mcmc.initialise import init_split_wells

        spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0),
                                 num_wells=2, V0_list=(-10.0, -10.5),
                                 r0=1.2, k=15.0)
        pos, _ = init_split_wells(chains, n, 0.03)
        state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0),
                                 0.65)
    out = run_moves_pallas(spec, 1.0, state, moves, seed=2,
                           interpret=interpret)
    kern = resync_energy(spec, out)
    np.testing.assert_allclose(np.asarray(out.energy),
                               np.asarray(kern.energy), rtol=1e-4,
                               atol=1e-3)
    plain = run_moves_batch(spec, 1.0, state, moves)
    acc_k = float(np.mean(np.asarray(kern.accepts) / moves))
    acc_p = float(np.mean(np.asarray(plain.accepts) / moves))
    assert abs(acc_k - acc_p) < 0.02, (acc_k, acc_p)
    e_k = np.asarray(kern.energy, np.float64)
    e_p = np.asarray(plain.energy, np.float64)
    se = np.sqrt(e_k.var() / chains + e_p.var() / chains)
    assert abs(e_k.mean() - e_p.mean()) < 3 * se, (e_k.mean(), e_p.mean())


def test_kernel_matches_plain_engine():
    _compare_with_plain_engine(256, 400, interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_engine():
    _require_gpu()
    _compare_with_plain_engine(4096, 2048, interpret=False)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_engine_at_max_particles():
    """The compiled kernel at its largest tile (N = MAX_PARTICLES): exact
    bookkeeping and the plain engine's statistics."""
    _require_gpu()
    _compare_with_plain_engine(1024, 500, interpret=False, n=MAX_PARTICLES)
