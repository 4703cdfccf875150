"""Tests for the flow library: layer invariants and model algebra.

Follows the reference harness strategy (``flows/flow_test.py:7-48``
checkForwardInverse: round-trip identity + log-det antisymmetry) and adds
oracles the reference lacks: exact Jacobian log-determinant via autodiff and
torus periodicity of the model density.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import (
    CircularSplineCoupling, CoupledRationalQuadraticSpline, DoubleWellLJ,
    NormalizingFlow, UniformParticle, build_circular_flow,
)

D = 6  # 3 particles x 2 dims
BOUND = 5.0


def _layer(net_type="residual", reverse_mask=False):
    return CircularSplineCoupling(
        features=D, num_blocks=2, hidden_units=32,
        ind_circ=tuple(range(D)), num_bins=8, tail_bound=BOUND,
        net_type=net_type, reverse_mask=reverse_mask)


def _perturbed_params(layer, key):
    """Identity-init params perturbed so the transform is non-trivial."""
    params = layer.init_params(key)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.fold_in(key, 1), len(leaves))
    leaves = [l + 0.3 * jax.random.normal(k, l.shape)
              for l, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("net_type", ["residual", "transformer", "gnn"])
def test_coupling_forward_inverse(net_type):
    layer = _layer(net_type)
    key = jax.random.key(0)
    params = _perturbed_params(layer, key)
    x = jax.random.uniform(jax.random.key(1), (16, D),
                           minval=-BOUND, maxval=BOUND)
    y, ld = layer.forward(params, x)
    x_back, ld_inv = layer.inverse(params, y)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=5e-3)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=5e-3)
    assert np.all(np.abs(np.asarray(y)) <= BOUND + 1e-4)


def test_coupling_identity_init():
    """With identity init, the layer is the half-roll permutation only."""
    layer = _layer()
    params = layer.init_params(jax.random.key(0))
    x = jax.random.uniform(jax.random.key(1), (8, D),
                           minval=-BOUND, maxval=BOUND)
    y, ld = layer.inverse(params, x)  # coupling forward incl. roll
    expected = jnp.concatenate([x[:, D // 2:], x[:, :D // 2]], axis=1)
    np.testing.assert_allclose(np.asarray(y), np.asarray(expected), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-3)


def test_coupling_logdet_matches_autodiff_jacobian():
    layer = _layer()
    params = _perturbed_params(layer, jax.random.key(3))

    def f(x):
        y, _ = layer.forward(params, x[None, :])
        return y[0]

    x = jax.random.uniform(jax.random.key(4), (D,),
                           minval=-0.9 * BOUND, maxval=0.9 * BOUND)
    J = jax.jacfwd(f)(x)
    _, logdet = jax.jit(layer.forward)(params, x[None, :])
    sign, exact = np.linalg.slogdet(np.asarray(J))
    # the half-roll is an odd permutation for D=6 -> det < 0; the flow's
    # log|det| must still match exactly
    assert abs(sign) == 1
    np.testing.assert_allclose(float(logdet[0]), exact, atol=1e-3)


def _model(K=3, target=None):
    return build_circular_flow(3, 2, BOUND, K=K, hidden_units=32,
                               num_bins=8, num_blocks=2, target=target)


def test_model_forward_inverse_roundtrip():
    model = _model()
    params = model.init_params(jax.random.key(0))
    # perturb so layers are non-trivial
    params = jax.tree_util.tree_map(
        lambda l: l + 0.2 * jax.random.normal(jax.random.key(7), l.shape),
        params)
    x = jax.random.uniform(jax.random.key(1), (12, D),
                           minval=-BOUND, maxval=BOUND)
    z, ld_inv = model.inverse_and_log_det(params, x)
    x_back, ld_fwd = model.forward_and_log_det(params, z)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=5e-3)
    np.testing.assert_allclose(np.asarray(ld_inv + ld_fwd), 0.0, atol=5e-3)


def test_model_log_prob_normalized_identity_init():
    """Identity-init flow = uniform base: log q = -D log(2 bound)."""
    model = _model()
    params = model.init_params(jax.random.key(0))
    x = jax.random.uniform(jax.random.key(2), (10, D),
                           minval=-BOUND, maxval=BOUND)
    lp = model.log_prob(params, x)
    np.testing.assert_allclose(np.asarray(lp), -D * np.log(2 * BOUND),
                               atol=1e-2)


def test_model_samples_in_bounds_and_log_prob_consistent():
    model = _model()
    params = model.init_params(jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda l: l + 0.1 * jax.random.normal(jax.random.key(9), l.shape),
        params)
    samples, log_q = model.sample_and_log_prob(params, jax.random.key(5), 64)
    assert samples.shape == (64, D)
    assert np.all(np.abs(np.asarray(samples)) <= BOUND + 1e-4)
    lp = model.log_prob(params, samples)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(log_q), atol=5e-3)


def test_model_density_torus_periodicity():
    """q(x) = q(x + L e_i): the circular flow defines a density on the torus."""
    model = _model()
    params = model.init_params(jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda l: l + 0.1 * jax.random.normal(jax.random.key(11), l.shape),
        params)
    x = jax.random.uniform(jax.random.key(6), (8, D),
                           minval=-BOUND, maxval=BOUND)
    lp = model.log_prob(params, x)
    # shift one coordinate by the period, re-wrap into the box
    L = 2 * BOUND
    x_shift = x.at[:, 2].add(L)
    x_shift = x_shift - L * jnp.round(x_shift / L)
    np.testing.assert_allclose(np.asarray(x_shift[:, 2]),
                               np.asarray(x[:, 2]), atol=1e-4)
    lp2 = model.log_prob(params, x_shift)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(lp2), atol=1e-3)


def test_forward_kld_finite_and_grads():
    model = _model()
    params = model.init_params(jax.random.key(0))
    x = jax.random.uniform(jax.random.key(2), (32, D),
                           minval=-BOUND, maxval=BOUND)
    loss, grads = jax.value_and_grad(model.forward_kld)(params, x)
    assert np.isfinite(float(loss))
    flat = jax.tree_util.tree_leaves(grads)
    assert all(np.all(np.isfinite(np.asarray(g))) for g in flat)
    assert any(float(jnp.max(jnp.abs(g))) > 0 for g in flat)


def test_reverse_kld_tuple_form():
    target = DoubleWellLJ(dim=D, n_particles=3, temperature=1.0, bound=BOUND,
                          V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    model = _model(target=target)
    params = model.init_params(jax.random.key(0))
    loss, z = model.reverse_kld(params, jax.random.key(1), 32)
    assert z.shape == (32, D)
    assert np.isfinite(float(loss))


def test_linear_tail_coupling_roundtrip():
    layer = CoupledRationalQuadraticSpline(
        features=4, num_blocks=2, hidden_units=16, num_bins=6,
        tail_bound=3.0)
    key = jax.random.key(0)
    params = layer.init_params(key)
    params = jax.tree_util.tree_map(
        lambda l: l + 0.3 * jax.random.normal(key, l.shape), params)
    x = jax.random.normal(jax.random.key(1), (16, 4)) * 2.0
    y, ld = layer.forward(params, x)
    x_back, ld_inv = layer.inverse(params, y)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=2e-3)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=2e-3)


def test_uniform_particle_base():
    base = UniformParticle(3, 2, BOUND)
    s = base.sample(jax.random.key(0), 100)
    assert s.shape == (100, D)
    assert np.all(np.abs(np.asarray(s)) <= BOUND)
    lp = base.log_prob(s)
    np.testing.assert_allclose(np.asarray(lp), -D * np.log(2 * BOUND),
                               atol=1e-5)
    out = base.log_prob(jnp.full((1, D), BOUND + 1.0))
    assert np.isneginf(float(out[0]))


def test_save_load_roundtrip(tmp_path):
    model = _model()
    params = model.init_params(jax.random.key(0))
    path = str(tmp_path / "model.pkl")
    model.save(params, path)
    loaded = model.load(path)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_forward_kld_base_term_flag():
    """The fork omits the base log-prob in forward_kld (core.py:102); the
    include_base flag restores it — constant -D log(2b) in bounds."""
    model = _model()
    params = model.init_params(jax.random.key(0))
    x = jax.random.uniform(jax.random.key(1), (16, D),
                           minval=-BOUND, maxval=BOUND)
    loss_fork = model.forward_kld(params, x)                 # identity: 0
    loss_full = model.forward_kld(params, x, include_base=True)
    np.testing.assert_allclose(float(loss_fork), 0.0, atol=1e-3)
    np.testing.assert_allclose(float(loss_full), D * np.log(2 * BOUND),
                               atol=1e-2)


def test_uniform_gaussian_fork_semantics():
    """base.py:245-275 fork quirk: sample() draws uniform noise for BOTH
    groups, log_prob returns only the uniform part."""
    from flowstate.flows import UniformGaussian
    d = 4
    fork = UniformGaussian(dim=d, ind_uniform=(0, 1), scale=(2.0,) * d)
    s = fork.sample(jax.random.key(0), 2000)
    # gaussian-group entries are bounded (uniform draw) in fork mode
    assert float(jnp.max(jnp.abs(s[:, 2:]))) <= 1.0 + 1e-6
    lp = fork.log_prob(s)
    np.testing.assert_allclose(np.asarray(lp), -2 * np.log(2.0), atol=1e-6)

    fixed = UniformGaussian(dim=d, ind_uniform=(0, 1), scale=(2.0,) * d,
                            fork_semantics=False)
    s2 = fixed.sample(jax.random.key(0), 2000)
    assert float(jnp.max(jnp.abs(s2[:, 2:]))) > 2.0  # actually gaussian
    lp2 = fixed.log_prob(s2)
    assert np.std(np.asarray(lp2)) > 0.1  # gaussian part varies


def test_scanned_layers_equal_unrolled():
    """scan-over-layers flow == unrolled flow on identical stacked params."""
    from flowstate.flows.core import ScannedLayers
    layer = _layer()
    K = 4
    scanned = ScannedLayers(layer, K)
    params = scanned.init_params(jax.random.key(0))
    params = jax.tree_util.tree_map(
        lambda l: l + 0.2 * jax.random.normal(jax.random.key(1), l.shape),
        params)
    x = jax.random.uniform(jax.random.key(2), (8, D),
                           minval=-BOUND, maxval=BOUND)
    y_s, ld_s = scanned.forward(params, x)
    # unrolled: slice layer i's params out of the stacked pytree
    y_u = x
    ld_u = jnp.zeros(8)
    for i in range(K):
        p_i = jax.tree_util.tree_map(lambda l: l[i], params)
        y_u, d = layer.forward(p_i, y_u)
        ld_u = ld_u + d
    np.testing.assert_allclose(np.asarray(y_s), np.asarray(y_u), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ld_s), np.asarray(ld_u), atol=1e-4)
    # inverse round trip through the scan
    x_back, ld_inv = scanned.inverse(params, y_s)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=2e-3)
    np.testing.assert_allclose(np.asarray(ld_s + ld_inv), 0.0, atol=2e-3)
