"""Blocked conditional-flow proposal tests (mcmc/blocked.py).

The machinery that attacks the measured N-wall: k-particle resampling
conditioned on the other N-k positions, MH-corrected with conditional
log-probs (generalizing the reference's ``nf_big_move``,
MCMC/monte_carlo.py:235-303, via the conditioning path it never used,
NF/normflows/core.py:233-383 + nets/resnet.py:48-49).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import build_conditional_circular_flow
from flowstate.mcmc import (
    block_context, blocked_big_moves, context_dim, init_chain_state,
    random_block_onehots, run_moves_batch, run_production_batch,
    scatter_block, select_particles,
)
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig
from flowstate.training.blocked import blocked_pairs, train_blocked


def _spec(n, rho=0.03):
    return SystemSpec.create(n, Box.from_density(n, rho, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def _perturbed_flow(n, k, K=3, hidden=32, bins=5, seed=0, noise=0.3):
    model = build_conditional_circular_flow(
        k, 2, 5.0, context_features=context_dim(n, k), K=K,
        hidden_units=hidden, num_bins=bins)
    params = model.init_params(jax.random.key(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    leaves = [l + noise * jax.random.normal(kk, l.shape)
              for l, kk in zip(leaves, keys)]
    return model, jax.tree_util.tree_unflatten(treedef, leaves)


def test_onehot_select_scatter_match_indexing():
    key = jax.random.key(0)
    b, n, k = 7, 9, 3
    sel, rest = random_block_onehots(key, b, n, k)
    # each row of sel/rest is one-hot; together they cover all particles
    assert np.allclose(np.asarray(sel.sum(-1)), 1.0)
    assert np.allclose(np.asarray(rest.sum(-1)), 1.0)
    cover = np.asarray(sel.sum(1) + rest.sum(1))
    assert np.allclose(cover, 1.0)

    pos = jax.random.uniform(jax.random.key(1), (b, n, 2))
    picked = np.asarray(select_particles(sel, pos))
    idx = np.argmax(np.asarray(sel), axis=-1)          # (b, k)
    expected = np.take_along_axis(np.asarray(pos), idx[..., None], axis=1)
    np.testing.assert_allclose(picked, expected, rtol=1e-6)

    new_block = jax.random.uniform(jax.random.key(2), (b, k, 2))
    out = np.asarray(scatter_block(sel, new_block, pos))
    expected_out = np.asarray(pos).copy()
    for bi in range(b):
        expected_out[bi, idx[bi]] = np.asarray(new_block)[bi]
    np.testing.assert_allclose(out, expected_out, rtol=1e-6)


def test_block_context_periodic_features():
    b, n, k, hb = 4, 5, 2, 5.0
    sel, rest = random_block_onehots(jax.random.key(3), b, n, k)
    pos = jax.random.uniform(jax.random.key(4), (b, n, 2), maxval=2 * hb)
    ctx = block_context(rest, pos, hb)
    assert ctx.shape == (b, context_dim(n, k))
    # periodicity: shifting a conditioning coord by the box length L=2*hb
    # leaves the features unchanged (torus featurization)
    ctx2 = block_context(rest, pos + 2 * hb, hb)
    np.testing.assert_allclose(np.asarray(ctx), np.asarray(ctx2), atol=1e-4)


def test_conditional_roundtrip_and_logdet():
    n, k = 6, 2
    model, params = _perturbed_flow(n, k)
    b = 16
    x = jax.random.uniform(jax.random.key(5), (b, 2 * k), minval=-5.0,
                           maxval=5.0)
    ctx = jax.random.normal(jax.random.key(6), (b, context_dim(n, k)))
    z, ld_inv = model.inverse_and_log_det(params, x, context=ctx)
    x2, ld_fwd = model.forward_and_log_det(params, z, context=ctx)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ld_fwd + ld_inv),
                               np.zeros(b), atol=1e-3)
    # context must actually matter: a different context changes the map
    ctx_b = ctx + 1.0
    z_b, _ = model.inverse_and_log_det(params, x, context=ctx_b)
    assert float(jnp.abs(z - z_b).max()) > 1e-3


def test_sample_and_log_prob_consistency():
    n, k = 5, 2
    model, params = _perturbed_flow(n, k, seed=2)
    b = 32
    ctx = jax.random.normal(jax.random.key(7), (b, context_dim(n, k)))
    x, log_q = model.sample_and_log_prob(params, jax.random.key(8), b,
                                         context=ctx)
    log_q2 = model.log_prob(params, x, context=ctx)
    np.testing.assert_allclose(np.asarray(log_q), np.asarray(log_q2),
                               atol=2e-3)


def test_conditional_density_normalized_k1():
    """∫ q(x | ctx) dx = 1 over the torus for a non-trivial conditional."""
    n, k = 4, 1
    model, params = _perturbed_flow(n, k, seed=3)
    g, hb = 64, 5.0
    xs = (np.arange(g) + 0.5) / g * 2 * hb - hb
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    grid = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], -1),
                       jnp.float32)
    ctx_row = jax.random.normal(jax.random.key(9), (context_dim(n, k),))
    ctx = jnp.broadcast_to(ctx_row, (grid.shape[0], ctx_row.shape[0]))
    log_q = np.asarray(model.log_prob(params, grid, context=ctx))
    cell = (2 * hb / g) ** 2
    integral = np.exp(log_q).sum() * cell
    assert abs(integral - 1.0) < 0.02, integral


def test_scanned_context_equals_unrolled():
    n, k, K = 5, 2, 3
    scanned = build_conditional_circular_flow(
        k, 2, 5.0, context_features=context_dim(n, k), K=K,
        hidden_units=16, num_bins=4, scan_layers=True)
    unrolled = build_conditional_circular_flow(
        k, 2, 5.0, context_features=context_dim(n, k), K=K,
        hidden_units=16, num_bins=4, scan_layers=False)
    stacked = scanned.init_params(jax.random.key(10))
    per_layer = tuple(
        jax.tree_util.tree_map(lambda a, i=i: a[i], stacked[0])
        for i in range(K))
    b = 8
    x = jax.random.uniform(jax.random.key(11), (b, 2 * k), minval=-5.0,
                           maxval=5.0)
    ctx = jax.random.normal(jax.random.key(12), (b, context_dim(n, k)))
    lp_s = scanned.log_prob(stacked, x, context=ctx)
    lp_u = unrolled.log_prob(per_layer, x, context=ctx)
    np.testing.assert_allclose(np.asarray(lp_s), np.asarray(lp_u),
                               atol=1e-5)


def test_blocked_mh_matches_metropolis_occupancy():
    """Identity-init conditional flow => uniform block proposals; the
    blocked MH chain must reproduce the Metropolis engine's well
    occupancy (the engine side is quadrature/parity-tested already).

    SHALLOW wells (-2/-2.5 k_BT) so the local-move baseline actually
    equilibrates within the test budget — with the production 10 k_BT
    wells the Metropolis chain cannot cross at all and the comparison
    would test nothing (first version of this test did exactly that: the
    blocked sampler reached dF=0.45 while stuck Metropolis read 0.02)."""
    n, k = 2, 1
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0),
                             num_wells=2, V0_list=(-2.0, -2.5), r0=1.2,
                             k=15.0)
    beta = 1.0
    lx, ly = float(spec.box.size_x), float(spec.box.size_y)
    hb = lx / 2
    c = 256

    pos0 = np.tile(np.array([[lx / 4, ly / 2], [lx / 4 + 1.1, ly / 2]]),
                   (c, 1, 1))
    pos0[c // 2:, :, 0] += lx / 2
    state = init_chain_state(spec, jnp.asarray(pos0), jax.random.key(13),
                             1.5)
    state = run_moves_batch(spec, beta, state, 400)

    model = build_conditional_circular_flow(
        k, 2, hb, context_features=context_dim(n, k), K=2,
        hidden_units=16, num_bins=4)
    params = model.init_params(jax.random.key(14))  # identity init

    @jax.jit
    def run_blocked(s):
        def body(st, _):
            res = blocked_big_moves(spec, beta, st, model, params, hb, k)
            return res.state, res.state.positions
        return jax.lax.scan(body, s, None, length=1200)

    s_end, traj = run_blocked(state)
    acc = float((s_end.accepts - state.accepts).sum()
                / (s_end.attempts - state.attempts).sum())
    assert 0.01 < acc < 0.9, acc

    xy = np.asarray(traj[400:]).reshape(-1, 2)
    radius = 1.1 * spec.r0
    in_a = np.hypot(xy[:, 0] - lx / 4, xy[:, 1] - ly / 2) <= radius
    in_b = np.hypot(xy[:, 0] - 3 * lx / 4, xy[:, 1] - ly / 2) <= radius
    df_blocked = np.log(in_b.sum() / in_a.sum())

    # Metropolis reference on the same system
    state_m = init_chain_state(spec, jnp.asarray(pos0), jax.random.key(15),
                               1.5)
    state_m = run_moves_batch(spec, beta, state_m, 800)
    _, obs = run_production_batch(spec, beta, state_m, 600, 5)
    xy_m = np.asarray(obs.positions).reshape(-1, 2)
    in_a_m = np.hypot(xy_m[:, 0] - lx / 4, xy_m[:, 1] - ly / 2) <= radius
    in_b_m = np.hypot(xy_m[:, 0] - 3 * lx / 4, xy_m[:, 1] - ly / 2) <= radius
    df_metro = np.log(in_b_m.sum() / in_a_m.sum())

    assert abs(df_blocked - df_metro) < 0.2, (df_blocked, df_metro)


def test_train_blocked_decreases_loss_and_helps_acceptance():
    n, k = 4, 2
    spec = _spec(n)
    beta = 1.0
    lx = float(spec.box.size_x)
    hb = lx / 2
    c = 128

    from flowstate.mcmc.initialise import init_alternating_wells
    pos, _ = init_alternating_wells(c, n, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(16),
                             0.65)
    state = run_moves_batch(spec, beta, state, 1500)
    _, obs = run_production_batch(spec, beta, state, 24, 25)
    configs = jnp.reshape(obs.positions, (-1, n, 2))   # (3072, N, 2)

    model = build_conditional_circular_flow(
        k, 2, hb, context_features=context_dim(n, k), K=4,
        hidden_units=32, num_bins=6)
    params = model.init_params(jax.random.key(17))
    # the trainer donates its carried TrainState (training/train.py
    # convention); keep a live copy of the identity init for the
    # acceptance comparison below
    params_init = jax.tree_util.tree_map(jnp.copy, params)
    cfg = TrainConfig(batch_size=256, epochs=4, lr=3e-3)
    params2, _, loss_epoch = train_blocked(model, params, configs, k, hb,
                                           cfg, jax.random.key(18))
    assert np.isfinite(loss_epoch).all()
    assert loss_epoch[-1] < loss_epoch[0] - 0.3, loss_epoch

    # trained conditional proposals must be accepted more often than the
    # identity-init (uniform) ones on the equilibrated ensemble
    def acc_of(p):
        s = state
        accs = []
        for i in range(6):
            res = blocked_big_moves(spec, beta, s, model, p, hb, k)
            s = res.state
            accs.append(np.asarray(res.accepted).mean())
        return float(np.mean(accs))

    assert acc_of(params2) > acc_of(params_init) * 1.5


def test_fourier_context_invariance():
    """The Fourier encoder is exactly permutation- and torus-invariant."""
    from flowstate.mcmc import fourier_context, fourier_context_dim

    b, n, k, hb = 6, 8, 2, 5.0
    sel, rest = random_block_onehots(jax.random.key(21), b, n, k)
    pos = jax.random.uniform(jax.random.key(22), (b, n, 2), maxval=2 * hb)
    ctx = fourier_context(rest, pos, hb, m_max=3)
    assert ctx.shape == (b, fourier_context_dim(3))

    # permute the rest rows (the conditioning-set ordering): identical ctx
    perm_rows = np.random.default_rng(0).permutation(n - k)
    rest_p = rest[:, perm_rows, :]
    ctx_p = fourier_context(rest_p, pos, hb, m_max=3)
    np.testing.assert_allclose(np.asarray(ctx), np.asarray(ctx_p),
                               atol=1e-5)
    # torus periodicity
    ctx_t = fourier_context(rest, pos + 2 * hb, hb, m_max=3)
    np.testing.assert_allclose(np.asarray(ctx), np.asarray(ctx_t),
                               atol=1e-4)
    # sensitivity: moving one conditioning particle changes the features
    pos2 = pos.at[:, :, 0].add(
        jnp.where(jnp.arange(n)[None, :] == int(np.argmax(
            np.asarray(rest[0, 0]))), 1.7, 0.0))
    ctx_m = fourier_context(rest, pos2, hb, m_max=3)
    assert float(jnp.abs(ctx - ctx_m).max()) > 1e-3


def test_blocked_pairs_shapes():
    s, n, k, hb = 100, 6, 2, 5.0
    configs = jax.random.uniform(jax.random.key(19), (s, n, 2),
                                 maxval=2 * hb)
    x, ctx = blocked_pairs(jax.random.key(20), configs, k, hb)
    assert x.shape == (s, 2 * k)
    assert ctx.shape == (s, context_dim(n, k))
    assert float(jnp.abs(x).max()) <= hb + 1e-5


def test_paired_lockstep_matches_separate_passes():
    """sample_and_log_prob_with_old (ONE K-step lockstep scan, batched
    per-step conditioners) must agree with the separate forward + inverse
    sweeps — same keys, same algebra, only batched-matmul rounding."""
    n, k = 5, 2
    model, params = _perturbed_flow(n, k, seed=4)
    b = 32
    ctx = jax.random.normal(jax.random.key(30), (b, context_dim(n, k)))
    x_old = jax.random.uniform(jax.random.key(31), (b, 2 * k),
                               minval=-5.0, maxval=5.0)
    key = jax.random.key(32)
    x_new, lq_new, lq_old = model.sample_and_log_prob_with_old(
        params, key, b, x_old, context=ctx)
    x_sep, lq_sep = model.sample_and_log_prob(params, key, b, context=ctx)
    lq_old_sep = model.log_prob(params, x_old, context=ctx)
    np.testing.assert_allclose(np.asarray(x_new), np.asarray(x_sep),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(lq_new), np.asarray(lq_sep),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(lq_old), np.asarray(lq_old_sep),
                               atol=1e-4, rtol=1e-4)


def test_blocked_big_moves_paired_equals_unpaired():
    n, k = 6, 2
    spec = _spec(n)
    hb = float(spec.box.size_x) / 2
    model = build_conditional_circular_flow(
        k, 2, hb, context_features=context_dim(n, k), K=3,
        hidden_units=16, num_bins=4)
    params = model.init_params(jax.random.key(33))
    c = 64
    pos = jax.random.uniform(jax.random.key(34), (c, n, 2),
                             maxval=2 * hb)
    state = init_chain_state(spec, pos, jax.random.key(35), 0.5)
    r_p = blocked_big_moves(spec, 1.0, state, model, params, hb, k,
                            paired=True)
    r_u = blocked_big_moves(spec, 1.0, state, model, params, hb, k,
                            paired=False)
    np.testing.assert_array_equal(np.asarray(r_p.accepted),
                                  np.asarray(r_u.accepted))
    np.testing.assert_allclose(np.asarray(r_p.ratio_log),
                               np.asarray(r_u.ratio_log), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(r_p.state.positions),
                               np.asarray(r_u.state.positions), atol=1e-5)
