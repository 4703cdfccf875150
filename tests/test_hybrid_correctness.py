"""The Hastings-correction regression test.

The reference's ``nf_big_move`` inverts the independence-sampler proposal
correction (monte_carlo.py:264-268: -beta dU - (NLL_new - NLL_old), i.e.
q_new/q_old instead of q_old/q_new).  With a *uniform* proposal the two
signs coincide, so the bug is invisible to symmetric-proposal tests; this
test uses a deliberately ASYMMETRIC analytic proposal and asserts that the
big-move chain converges to the Boltzmann distribution regardless of the
proposal bias — which only holds with the correct sign.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc import apply_big_moves, init_chain_state
from flowstate.ops import Box, SystemSpec, double_well_potential


@dataclasses.dataclass(frozen=True)
class BiasedHalfBoxProposal:
    """Analytic proposal: left half with prob 0.8, right half 0.2, uniform
    within the half.  Exposes the subset of the NormalizingFlow API that
    ``apply_big_moves`` touches (log_prob of centered flat coords)."""

    half_box: float = 5.0
    p_left: float = 0.8

    def sample_and_log_prob(self, params, key, n):
        kside, kpos = jax.random.split(key)
        left = jax.random.uniform(kside, (n,)) < self.p_left
        x = jax.random.uniform(kpos, (n, 2), minval=0.0, maxval=self.half_box)
        x0 = jnp.where(left, x[:, 0] - self.half_box, x[:, 0])
        flat = jnp.stack([x0, x[:, 1] - self.half_box / 2.0], axis=1)
        return flat, self.log_prob(params, flat)

    def log_prob(self, params, flat):
        area = self.half_box * self.half_box  # area of one half (centered y?)
        left = flat[:, 0] < 0
        dens = jnp.where(left, self.p_left, 1.0 - self.p_left) / area
        return jnp.log(dens)


def test_biased_proposal_still_samples_boltzmann():
    """Single particle, asymmetric wells, heavily biased proposal: the
    MH-corrected big-move chain must still reproduce the exact Boltzmann
    well ratio (independent of the proposal)."""
    box = Box.from_density(1, 0.01, 1.0)  # 10x10
    spec = SystemSpec.create(1, box, num_wells=2, V0_list=(-2.0, -2.5),
                             r0=1.2, k=15.0)
    beta = 1.0
    half_box = 5.0
    model = BiasedHalfBoxProposal(half_box=half_box)

    # exact well ratio by quadrature (same oracle as test_mcmc)
    g = 300
    xs = np.linspace(0, 10, g, endpoint=False) + 10 / g / 2
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    pts = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1))
    V = np.asarray(double_well_potential(pts, 10.0, 10.0,
                                         V0_list=[-2.0, -2.5], r0=1.2,
                                         k=15.0)).reshape(g, g)
    w = np.exp(-beta * V)
    radius = 1.1 * 1.2
    dA = np.hypot(xx - 2.5, yy - 5.0) <= radius
    dB = np.hypot(xx - 7.5, yy - 5.0) <= radius
    exact_dF = np.log(w[dB].sum() / w[dA].sum())

    # chains driven by big moves alone
    c = 1024
    pos0 = np.tile(np.array([[2.5, 5.0]]), (c, 1, 1))
    state = init_chain_state(spec, jnp.asarray(pos0), jax.random.key(0), 0.5)

    # NOTE: the proposal's y is uniform on [0, half_box) shifted — it only
    # covers y in [2.5, 7.5), which contains both wells entirely; the
    # proposal support includes all relevant configurations.
    @jax.jit
    def round_(state, key):
        k_prop, k_u = jax.random.split(key)
        flat, log_q = model.sample_and_log_prob(None, k_prop, c)
        proposals = (flat + jnp.asarray([half_box, half_box]))[:, None, :]
        u = jax.random.uniform(k_u, (c,))
        res = apply_big_moves(spec, beta, state, proposals, log_q, model,
                              None, half_box, u)
        return res.state

    key = jax.random.key(1)
    samples = []
    for i in range(300):
        key, k = jax.random.split(key)
        state = round_(state, k)
        if i >= 100:
            samples.append(np.asarray(state.positions[:, 0, :]))
    xy = np.concatenate(samples, axis=0)
    in_A = np.hypot(xy[:, 0] - 2.5, xy[:, 1] - 5.0) <= radius
    in_B = np.hypot(xy[:, 0] - 7.5, xy[:, 1] - 5.0) <= radius
    sampled_dF = np.log(in_B.sum() / max(in_A.sum(), 1))

    # With the reference's inverted correction the stationary distribution
    # picks up an extra q factor: expected bias ~ ln(0.2/0.8) = -1.39 on
    # top of exact_dF (~0.43) -> clearly separable from MC noise.
    assert abs(sampled_dF - exact_dF) < 0.15, (sampled_dF, exact_dF)


def test_wrong_sign_would_fail():
    """Sanity: applying the reference's inverted correction to the same
    setup produces a clearly different ratio (documents the bug)."""
    # implemented as a closed-form check of the two stationary laws:
    # correct: pi; inverted: proportional to pi * (q_new appears squared
    # via the detailed-balance solve) — for a two-region toy with
    # pi = (p, 1-p), q = (s, 1-s):
    p, s = 0.3, 0.8
    # correct ratio of occupancies
    correct = (1 - p) / p
    # inverted-correction stationary solves pi_i q_i flux balance:
    inverted = ((1 - p) * (1 - s)) / (p * s)
    assert abs(np.log(correct) - np.log(inverted)) > 1.0


def test_global_paired_lockstep_matches_separate_passes():
    """NormalizingFlow.sample_and_log_prob_with_old (the paired lockstep
    scan behind nf_big_moves) must agree with the separate forward +
    inverse sweeps, and nf_big_moves(paired=True/False) must make the
    same decisions."""
    from flowstate.flows import build_circular_flow
    from flowstate.mcmc import nf_big_moves

    n, hb = 3, 5.0
    model = build_circular_flow(n, 2, hb, K=4, hidden_units=16,
                                num_bins=4, num_blocks=2)
    params = model.init_params(jax.random.key(40))
    # perturb so the flow is non-identity
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.key(41), len(leaves))
    params = jax.tree_util.tree_unflatten(treedef, [
        l + 0.3 * jax.random.normal(kk, l.shape)
        for l, kk in zip(leaves, keys)])

    b = 32
    x_old = jax.random.uniform(jax.random.key(42), (b, 2 * n),
                               minval=-hb, maxval=hb)
    key = jax.random.key(43)
    x_new, lq_new, lq_old = model.sample_and_log_prob_with_old(
        params, key, b, x_old)
    x_sep, lq_sep = model.sample_and_log_prob(params, key, b)
    np.testing.assert_allclose(np.asarray(x_new), np.asarray(x_sep),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(lq_new), np.asarray(lq_sep),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(lq_old),
                               np.asarray(model.log_prob(params, x_old)),
                               atol=1e-4, rtol=1e-4)

    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0),
                             num_wells=2, V0_list=(-10.0, -10.5), r0=1.2,
                             k=15.0)
    pos = jax.random.uniform(jax.random.key(44), (b, n, 2),
                             maxval=2 * hb)
    state = init_chain_state(spec, pos, jax.random.key(45), 0.5)
    r_p = nf_big_moves(spec, 1.0, state, model, params, hb, paired=True)
    r_u = nf_big_moves(spec, 1.0, state, model, params, hb, paired=False)
    np.testing.assert_array_equal(np.asarray(r_p.accepted),
                                  np.asarray(r_u.accepted))
    np.testing.assert_allclose(np.asarray(r_p.ratio_log),
                               np.asarray(r_u.ratio_log), atol=1e-4,
                               rtol=1e-4)
