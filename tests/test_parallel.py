"""Multi-device tests on the virtual 8-CPU mesh: sharded MCMC, DP training,
and the full dryrun_multichip entry used by the driver."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import build_circular_flow
from flowstate.mcmc import init_alternating_wells, init_chain_state, run_moves_batch
from flowstate.ops import Box, SystemSpec
from flowstate.parallel import (
    CHAIN_AXIS, all_gather_samples, make_chain_mesh,
    make_data_parallel_train_step, psum_counter, shard_batch,
    shard_chain_state, sharded_chain_fn,
)
from flowstate.training import TrainConfig, TrainState, make_optimizer

GRAFT_ENTRY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "__graft_entry__.py")


def _spec():
    return SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def test_device_count():
    assert len(jax.devices()) == 8


def test_sharded_mcmc_matches_single_device():
    spec = _spec()
    mesh = make_chain_mesh(n_devices=4)
    pos, _ = init_alternating_wells(8, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0), 0.65)

    ref = run_moves_batch(spec, 1.0, state, 30)

    sharded_state = shard_chain_state(state, mesh)
    fn = sharded_chain_fn(lambda s: run_moves_batch(spec, 1.0, s, 30), mesh)
    out = jax.jit(fn)(sharded_state)

    # per-chain kernels are embarrassingly parallel: identical trajectories
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.accepts),
                                  np.asarray(ref.accepts))


def test_psum_counter_and_all_gather():
    mesh = make_chain_mesh(n_devices=4)
    v = shard_batch(jnp.arange(8, dtype=jnp.int32), mesh)
    total = psum_counter(v, mesh)
    assert int(total) == 28
    s = shard_batch(jnp.arange(8.0).reshape(8, 1), mesh)
    gathered = all_gather_samples(s, mesh)
    np.testing.assert_allclose(np.asarray(gathered).ravel(), np.arange(8.0))


def test_data_parallel_train_step_matches_single_device():
    model = build_circular_flow(3, 2, 5.0, K=2, hidden_units=16, num_bins=4,
                                num_blocks=1)
    params = model.init_params(jax.random.key(0))
    # perturb away from identity init so the loss is non-trivial
    params = jax.tree_util.tree_map(
        lambda l: l + 0.2 * jax.random.normal(jax.random.key(42), l.shape),
        params)
    config = TrainConfig(batch_size=16, epochs=1, lr=1e-3)
    optimizer = make_optimizer(config)

    batch = jax.random.uniform(jax.random.key(1), (16, 6), minval=-5.0,
                               maxval=5.0)

    # single-device step
    from flowstate.training import make_train_step
    step1 = make_train_step(model, config, optimizer)
    s1 = TrainState(params, optimizer.init(params), jax.random.key(2))
    s1_out, loss1 = step1(s1, batch)

    # data-parallel over 4 devices
    mesh = make_chain_mesh(n_devices=4)
    dp_step = make_data_parallel_train_step(model, config, optimizer, mesh)
    s2 = TrainState(params, optimizer.init(params), jax.random.key(2))
    s2_out, loss2 = dp_step(s2, shard_batch(batch, mesh))

    # forward-KLD loss is a mean over the batch -> pmean of shard means
    # equals the global mean; grads likewise -> identical update
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s1_out.params),
                    jax.tree_util.tree_leaves(s2_out.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)


def test_graft_entry_single_chip():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", GRAFT_ENTRY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(float(out))


def test_graft_entry_dryrun_multichip():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", GRAFT_ENTRY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    checks = mod.dryrun_multichip(8)
    assert checks["mc_max_rel"] <= mod.MC_REL_TOL
    assert checks["dp_loss_rel"] <= mod.DP_LOSS_REL_TOL
    assert checks["dp_params_max_abs"] <= mod.DP_PARAMS_ABS_TOL


def test_sharded_tempering_matches_single_device():
    """PT walkers shard over the mesh exactly like plain chains: the walker
    axis is data-parallel, the (small) replica axis stays on-device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flowstate.mcmc import (
        init_tempered_state, run_replica_exchange, temperature_ladder,
    )

    spec = _spec()
    mesh = make_chain_mesh(n_devices=4)
    betas = temperature_ladder(1.0, 4.0, 3)
    lx = spec.box.size_x
    pos = np.tile(np.array([[lx / 4, lx / 2], [lx / 4 + 1.1, lx / 2],
                            [lx / 4 - 0.6, lx / 2 + 0.9]], dtype=np.float32),
                  (3, 8, 1, 1))
    state = init_tempered_state(spec, jnp.asarray(pos), jax.random.key(3),
                                0.65)

    run = lambda s, k: run_replica_exchange(spec, betas, s, k,
                                            num_rounds=6, moves_per_round=10)
    ref = jax.jit(run)(state, jax.random.key(4))

    # shard the walker axis (axis 1 of every (R, W, ...) leaf)
    walker_sharding = NamedSharding(mesh, P(None, CHAIN_AXIS))
    sharded = jax.tree.map(
        lambda x: jax.device_put(x, walker_sharding), state)
    out = jax.jit(run)(sharded, jax.random.key(4))

    np.testing.assert_allclose(np.asarray(out.state.positions),
                               np.asarray(ref.state.positions), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.edge_acceptance),
                               np.asarray(ref.edge_acceptance), atol=1e-6)


def test_shard_map_tempering_matches_single_device():
    """PT under EXPLICIT shard_map over the walker axis: the swap uniforms
    must stay globally consistent, which the walker_offset/total_walkers
    path provides (every shard draws the global table and slices its
    columns) — bit-identical to the single-device run."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from flowstate.mcmc import (
        init_tempered_state, run_replica_exchange, temperature_ladder,
    )

    spec = _spec()
    mesh = make_chain_mesh(n_devices=4)
    r, w = 3, 8
    betas = temperature_ladder(1.0, 4.0, r)
    lx = spec.box.size_x
    pos = np.tile(np.array([[lx / 4, lx / 2], [lx / 4 + 1.1, lx / 2],
                            [lx / 4 - 0.6, lx / 2 + 0.9]], dtype=np.float32),
                  (r, w, 1, 1))
    state = init_tempered_state(spec, jnp.asarray(pos), jax.random.key(3),
                                0.65)
    key = jax.random.key(4)

    ref = jax.jit(lambda s: run_replica_exchange(
        spec, betas, s, key, num_rounds=6, moves_per_round=10))(state)

    def shard_fn(s):
        w_local = s.energy.shape[1]
        off = jax.lax.axis_index(CHAIN_AXIS) * w_local
        res = run_replica_exchange(
            spec, betas, s, key, num_rounds=6, moves_per_round=10,
            total_walkers=w, walker_offset=off)
        return (res.state, res.edge_acceptance[None],
                res.cold_positions, res.cold_energy)

    state_spec = jax.tree_util.tree_map(lambda _: P(None, CHAIN_AXIS), state)
    out_state, edge, cold_pos, cold_e = jax.jit(shard_map(
        shard_fn, mesh=mesh, in_specs=(state_spec,),
        out_specs=(state_spec, P(CHAIN_AXIS), P(None, CHAIN_AXIS),
                   P(None, CHAIN_AXIS))))(state)

    np.testing.assert_array_equal(np.asarray(out_state.positions),
                                  np.asarray(ref.state.positions))
    np.testing.assert_array_equal(np.asarray(cold_pos),
                                  np.asarray(ref.cold_positions))
    np.testing.assert_array_equal(np.asarray(cold_e),
                                  np.asarray(ref.cold_energy))
    # per-shard edge acceptances average (equal walker counts) to the global
    np.testing.assert_allclose(np.asarray(edge).reshape(4, r - 1).mean(0),
                               np.asarray(ref.edge_acceptance), atol=1e-6)


def test_replica_sharded_swap_crosses_shards():
    """The REPLICA axis sharded one-replica-per-device: swap partners live
    on neighbouring shards and move via ppermute — bit-identical to the
    unsharded swap_replicas, for both parities."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from flowstate.mcmc import (
        init_tempered_state, swap_replicas, swap_replicas_replica_sharded,
        temperature_ladder,
    )

    spec = _spec()
    r, w = 8, 4
    mesh = make_chain_mesh(n_devices=8)
    betas = temperature_ladder(1.0, 8.0, r)
    lx = spec.box.size_x
    rng = np.random.default_rng(5)
    base = np.array([[lx / 4, lx / 2], [lx / 4 + 1.1, lx / 2],
                     [lx / 4 - 0.6, lx / 2 + 0.9]], dtype=np.float32)
    pos = base[None, None] + rng.uniform(
        -0.05, 0.05, size=(r, w, 3, 2)).astype(np.float32)
    state = init_tempered_state(spec, jnp.asarray(pos), jax.random.key(6),
                                0.65)
    state_spec = jax.tree_util.tree_map(lambda _: P(CHAIN_AXIS), state)

    for parity in (0, 1):
        key = jax.random.key(10 + parity)
        ref = swap_replicas(betas, state, key, parity=parity)

        out = jax.jit(shard_map(
            lambda s: swap_replicas_replica_sharded(
                betas, s, key, parity, CHAIN_AXIS),
            mesh=mesh, in_specs=(state_spec,),
            out_specs=type(ref)(state_spec, P(CHAIN_AXIS), P(CHAIN_AXIS))))(
                state)

        assert bool(np.any(np.asarray(ref.accepted))), "want real swaps"
        np.testing.assert_array_equal(np.asarray(out.accepted),
                                      np.asarray(ref.accepted))
        np.testing.assert_array_equal(np.asarray(out.state.positions),
                                      np.asarray(ref.state.positions))
        np.testing.assert_array_equal(np.asarray(out.state.energy),
                                      np.asarray(ref.state.energy))


def test_sharded_mala_matches_single_device():
    """MALA consumes per-chain keys carried in ChainState, so the sharded
    run is bit-identical to the single-device run."""
    from flowstate.mcmc import run_mala_batch

    spec = _spec()
    mesh = make_chain_mesh(n_devices=4)
    pos, _ = init_alternating_wells(8, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(7), 0.02)

    ref = run_mala_batch(spec, 1.0, state, 25)

    sharded_state = shard_chain_state(state, mesh)
    fn = sharded_chain_fn(lambda s: run_mala_batch(spec, 1.0, s, 25), mesh)
    out = jax.jit(fn)(sharded_state)

    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(ref.positions))
    np.testing.assert_array_equal(np.asarray(out.accepts),
                                  np.asarray(ref.accepts))


def test_sharded_hmc_matches_single_device():
    """HMC, like MALA, consumes per-chain keys carried in ChainState, so
    the sharded run is bit-identical to the single-device run."""
    from flowstate.mcmc import run_hmc_batch

    spec = _spec()
    mesh = make_chain_mesh(n_devices=4)
    pos, _ = init_alternating_wells(8, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(11), 0.02)

    ref = run_hmc_batch(spec, 1.0, state, 15, num_leapfrog=5)

    sharded_state = shard_chain_state(state, mesh)
    fn = sharded_chain_fn(
        lambda s: run_hmc_batch(spec, 1.0, s, 15, num_leapfrog=5), mesh)
    out = jax.jit(fn)(sharded_state)

    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(ref.positions))
    np.testing.assert_array_equal(np.asarray(out.accepts),
                                  np.asarray(ref.accepts))
