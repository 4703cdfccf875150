"""Tests for the stock flow zoo: round-trip + log-det invariants per layer.

Mirrors the reference's shared ``FlowTest.checkForwardInverse`` harness
(``flows/flow_test.py:7-48``) for every layer family.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import (
    MADE, ActNorm, AffineConstFlow, AffineCouplingBlock, BatchNorm,
    CircularGaussianMixture, DiagGaussian, DiagGaussianProposal, HAIS,
    HamiltonianMonteCarlo, Invertible1x1Conv, InvertibleAffine,
    LULinearPermute, MaskedAffineAutoregressive, MaskedAffineFlow,
    MaskedPiecewiseRQSAutoregressive, Merge, MetropolisHastings, MLP,
    Permute, PeriodicShift, PeriodicWrap, Planar, Radial, RingMixture,
    Smiley, Split, Squeeze, TwoModes, TwoMoons, UniformBase,
)

D = 6
B = 16


def _check_forward_inverse(layer, params, z, atol=1e-4):
    """checkForwardInverse: x == inv(fwd(x)), ld_fwd + ld_inv == 0."""
    y, ld = layer.forward(params, z)
    z_back, ld_inv = layer.inverse(params, y)
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=atol)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=atol)
    return y, ld


def _rand(key=0, shape=(B, D)):
    return jax.random.normal(jax.random.key(key), shape)


def test_affine_const_flow():
    layer = AffineConstFlow(D)
    params = {"s": 0.3 * _rand(1, (D,)), "t": _rand(2, (D,))}
    y, ld = _check_forward_inverse(layer, params, _rand())
    np.testing.assert_allclose(np.asarray(ld),
                               float(jnp.sum(params["s"])), rtol=1e-5)


def test_masked_affine_flow_roundtrip():
    s_net = MLP((D, 16, D))
    t_net = MLP((D, 16, D))
    layer = MaskedAffineFlow(b=tuple([1, 0] * 3), s_net=s_net, t_net=t_net)
    params = layer.init_params(jax.random.key(0))
    _check_forward_inverse(layer, params, _rand(), atol=1e-3)


def test_affine_coupling_block_scale_maps():
    for scale_map in ["exp", "sigmoid", "sigmoid_inv"]:
        pm = MLP((D // 2, 16, D))  # interleaved shift/scale for D/2 dims
        layer = AffineCouplingBlock(pm, scale=True, scale_map=scale_map)
        params = layer.init_params(jax.random.key(3))
        _check_forward_inverse(layer, params, _rand(4), atol=1e-3)


def test_permute_modes():
    for mode in ["shuffle", "swap"]:
        layer = Permute(D, mode=mode)
        _check_forward_inverse(layer, {}, _rand(5))


def test_invertible_affine_lu_and_dense():
    for use_lu in [True, False]:
        layer = InvertibleAffine(D, use_lu=use_lu)
        params = layer.init_params(jax.random.key(6))
        z = _rand(7)
        y, ld = _check_forward_inverse(layer, params, z, atol=1e-3)
        # log-det vs slogdet of the exact Jacobian
        J = jax.jacfwd(lambda x: layer.forward(params, x[None])[0][0])(z[0])
        _, exact = np.linalg.slogdet(np.asarray(J))
        np.testing.assert_allclose(float(ld[0]), exact, atol=1e-4)


def test_lu_linear_permute():
    layer = LULinearPermute(D)
    params = layer.init_params(jax.random.key(8))
    _check_forward_inverse(layer, params, _rand(9), atol=1e-3)


def test_invertible_1x1_conv():
    layer = Invertible1x1Conv(4)
    params = layer.init_params(jax.random.key(10))
    z = _rand(11, (2, 4, 3, 3))
    y, ld = layer.forward(params, z)
    z_back, ld_inv = layer.inverse(params, y)
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-4)


def test_planar_leaky_relu_inverse_and_logdet():
    layer = Planar(D, act="leaky_relu")
    params = layer.init_params(jax.random.key(12))
    z = _rand(13)
    _check_forward_inverse(layer, params, z, atol=1e-3)
    # log-det vs exact Jacobian
    J = jax.jacfwd(lambda x: layer.forward(params, x[None])[0][0])(z[0])
    _, ld = layer.forward(params, z[:1])
    sign, exact = np.linalg.slogdet(np.asarray(J))
    np.testing.assert_allclose(float(ld[0]), exact, atol=1e-4)


def test_planar_tanh_forward_logdet():
    layer = Planar(D, act="tanh")
    params = layer.init_params(jax.random.key(14))
    z = _rand(15)
    J = jax.jacfwd(lambda x: layer.forward(params, x[None])[0][0])(z[0])
    _, ld = layer.forward(params, z[:1])
    _, exact = np.linalg.slogdet(np.asarray(J))
    np.testing.assert_allclose(float(ld[0]), exact, atol=1e-4)


def test_radial_logdet_matches_jacobian():
    layer = Radial(D)
    params = layer.init_params(jax.random.key(16))
    z = _rand(17)
    J = jax.jacfwd(lambda x: layer.forward(params, x[None])[0][0])(z[0])
    _, ld = layer.forward(params, z[:1])
    _, exact = np.linalg.slogdet(np.asarray(J))
    np.testing.assert_allclose(float(ld[0]), exact, atol=1e-4)


def test_actnorm_data_init():
    layer = ActNorm(D)
    z = 3.0 + 2.0 * _rand(18, (256, D))
    params = layer.init_params_from_data(z)
    y, ld = layer.forward(params, z)
    np.testing.assert_allclose(np.asarray(y).mean(axis=0), 0.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(y).std(axis=0), 1.0, atol=1e-2)
    _check_forward_inverse(layer, params, _rand(19))


def test_batchnorm_forward():
    layer = BatchNorm()
    z = 5.0 + 3.0 * _rand(20, (512, D))
    y, ld = layer.forward({}, z)
    np.testing.assert_allclose(np.asarray(y).mean(axis=0), 0.0, atol=1e-4)
    assert ld.shape == (512,)


def test_periodic_wrap_shift():
    wrap = PeriodicWrap(ind=(0, 1), bound=2.0)
    z = jnp.array([[2.5, -3.5, 0.7], [1.0, 1.0, 1.0]])
    z_w, _ = wrap.inverse({}, z)
    np.testing.assert_allclose(np.asarray(z_w[0]), [-1.5, 0.5, 0.7],
                               atol=1e-6)
    shift = PeriodicShift(ind=(0,), bound=2.0, shift=1.0)
    y, _ = shift.forward({}, z)
    z_back, _ = shift.inverse({}, y)
    # round trip modulo the wrap
    np.testing.assert_allclose(np.asarray(z_back[1]), [1.0, 1.0, 1.0],
                               atol=1e-6)


def test_split_merge_channel_and_checkerboard():
    for mode in ["channel", "channel_inv", "checkerboard",
                 "checkerboard_inv"]:
        split = Split(mode=mode)
        merge = Merge(mode=mode)
        z = _rand(21)
        (z1, z2), _ = split.forward({}, z)
        z_back, _ = split.inverse({}, [z1, z2])
        np.testing.assert_allclose(np.asarray(z_back), np.asarray(z),
                                   atol=1e-6)
        # merge is split reversed
        merged, _ = merge.forward({}, [z1, z2])
        np.testing.assert_allclose(np.asarray(merged), np.asarray(z),
                                   atol=1e-6)


def test_squeeze_roundtrip():
    layer = Squeeze()
    z = _rand(22, (2, 8, 4, 4))
    down, _ = layer.forward({}, z)   # un-squeeze: (2, 2, 8, 8)
    assert down.shape == (2, 2, 8, 8)
    back, _ = layer.inverse({}, down)
    np.testing.assert_allclose(np.asarray(back), np.asarray(z), atol=1e-6)


def test_made_autoregressive_property():
    made = MADE(features=5, hidden_features=32, num_blocks=2,
                output_multiplier=3)
    params = made.init_params(jax.random.key(23))
    x = _rand(24, (1, 5))
    # output block i must not depend on inputs >= i
    J = jax.jacfwd(lambda v: made.apply(params, v[None])[0])(x[0])
    J = np.asarray(J).reshape(5, 3, 5)  # (feature, param, input)
    for i in range(5):
        assert np.allclose(J[i, :, i:], 0.0, atol=1e-7), i


def test_masked_affine_autoregressive():
    layer = MaskedAffineAutoregressive(D, hidden_features=32)
    params = layer.init_params(jax.random.key(25))
    _check_forward_inverse(layer, params, _rand(26), atol=1e-3)


@pytest.mark.parametrize("tails", [None, "linear", "circular"])
def test_masked_rqs_autoregressive(tails):
    layer = MaskedPiecewiseRQSAutoregressive(
        D, hidden_features=32, num_bins=6, tails=tails, tail_bound=3.0)
    params = layer.init_params(jax.random.key(27))
    # perturb final layer so the transform is non-trivial
    params = jax.tree_util.tree_map(
        lambda l: l + 0.3 * jax.random.normal(jax.random.key(28), l.shape),
        params)
    z = jax.random.uniform(jax.random.key(29), (B, D), minval=-2.5,
                           maxval=2.5)
    _check_forward_inverse(layer, params, z, atol=2e-3)


def test_metropolis_hastings_layer_targets_density():
    target = DiagGaussian(2, trainable=False)

    class _T:
        def log_prob(self, z):
            return target.log_prob(z)

    layer = MetropolisHastings(_T(), DiagGaussianProposal(2, scale=1.0),
                               steps=50)
    params = layer.init_params(jax.random.key(30))
    z0 = 5.0 * _rand(31, (512, 2))
    z, _ = layer.forward(params, z0, jax.random.key(32))
    # after 50 MH steps the batch should be near-standard-normal
    assert abs(float(jnp.mean(z))) < 0.3
    assert 0.6 < float(jnp.std(z)) < 1.4


def test_hmc_layer_moves_toward_target():
    target = DiagGaussian(2, trainable=False)

    class _T:
        def log_prob(self, z):
            return target.log_prob(z)

    layer = HamiltonianMonteCarlo(_T(), steps=5, dim=2)
    params = layer.init_params(jax.random.key(33))
    z0 = 4.0 + _rand(34, (256, 2))
    z, _ = layer.forward(params, z0, jax.random.key(35))
    assert float(jnp.mean(z)) < 4.0  # moved toward the origin


def test_hais_weights_estimate_normalizer():
    """HAIS log-weights must estimate log Z of a known unnormalized target."""
    prior = DiagGaussian(2, trainable=False)

    class _Prior:
        def sample(self, key, n):
            return prior.sample(key, n)

        def log_prob(self, z):
            return prior.log_prob(z)

    class _Target:
        # unnormalized N(0, 0.5^2 I) * C with log C = 1.7
        def log_prob(self, z):
            return -jnp.sum(z**2, axis=-1) / (2 * 0.25) + 1.7

    betas = tuple(np.linspace(1.0, 0.0, 12))
    hais = HAIS(betas=betas, prior=_Prior(), target=_Target(),
                num_leapfrog=3, dim=2, step_size=0.2)
    params = hais.init_params(jax.random.key(36))
    _, log_w = hais.sample(params, jax.random.key(37), 2048)
    log_z_est = float(jax.scipy.special.logsumexp(log_w)
                      - jnp.log(log_w.shape[0]))
    # AIS estimates Z_target / Z_prior with a normalized prior, so
    # log Z = log C + log(2 pi sigma^2) = 1.7 + log(2 pi 0.25)
    exact = 1.7 + np.log(2 * np.pi * 0.25)
    assert abs(log_z_est - exact) < 0.25, (log_z_est, exact)


def test_toy_targets_evaluate():
    z = _rand(38, (32, 2))
    for t in [TwoMoons(), CircularGaussianMixture(), RingMixture(),
              TwoModes(2.0, 0.2), Smiley(0.5)]:
        lp = t.log_prob(z)
        assert lp.shape == (32,)
        assert np.all(np.isfinite(np.asarray(lp)))
    s = CircularGaussianMixture().sample(jax.random.key(39), 100)
    assert s.shape == (100, 2)
    s2 = TwoMoons().sample(jax.random.key(40), 64)
    assert s2.shape == (64, 2)
    # rejection-sampled points have high density
    assert float(jnp.mean(TwoMoons().log_prob(s2))) > -3.0


def test_logit_transform_roundtrip_and_logdet():
    from flowstate.flows import LogitTransform, Shift
    layer = LogitTransform(alpha=0.05)
    z = jax.random.normal(jax.random.key(50), (16, 4))
    x, ld = layer.forward({}, z)
    assert np.all((np.asarray(x) >= -0.06) & (np.asarray(x) <= 1.06))
    z_back, ld_inv = layer.inverse({}, x)
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-3)
    # log-det vs autodiff
    J = jax.jacfwd(lambda v: layer.forward({}, v[None])[0][0])(z[0])
    _, exact = np.linalg.slogdet(np.asarray(J))
    np.testing.assert_allclose(float(ld[0]), exact, atol=1e-4)

    sh = Shift(-0.5)
    y, _ = sh.forward({}, z)
    z2, _ = sh.inverse({}, y)
    np.testing.assert_allclose(np.asarray(z2), np.asarray(z), atol=1e-6)


def test_autoregressive_rqs_wrapper_roundtrip():
    from flowstate.flows import AutoregressiveRationalQuadraticSpline
    layer = AutoregressiveRationalQuadraticSpline(
        num_input_channels=D, num_blocks=2, num_hidden_channels=16,
        num_bins=4, tail_bound=3.0, init_identity=False)
    params = layer.init_params(jax.random.key(60))
    _check_forward_inverse(layer, params, 0.5 * _rand(61), atol=1e-3)


def test_circular_autoregressive_rqs_wrapper_roundtrip():
    from flowstate.flows import (
        CircularAutoregressiveRationalQuadraticSpline)
    # mixed tails: dims 0, 2, 4 circular, rest linear (wrapper.py:377-379)
    layer = CircularAutoregressiveRationalQuadraticSpline(
        num_input_channels=D, num_blocks=2, num_hidden_channels=16,
        ind_circ=(0, 2, 4), num_bins=4, tail_bound=1.0, init_identity=False)
    params = layer.init_params(jax.random.key(62))
    z = jnp.clip(0.5 * _rand(63), -0.99, 0.99)
    _check_forward_inverse(layer, params, z, atol=1e-3)


def test_autoregressive_rqs_wrapper_identity_init():
    from flowstate.flows import AutoregressiveRationalQuadraticSpline
    layer = AutoregressiveRationalQuadraticSpline(
        num_input_channels=D, num_blocks=2, num_hidden_channels=16,
        num_bins=4, tail_bound=3.0, init_identity=True)
    params = layer.init_params(jax.random.key(64))
    z = 0.5 * _rand(65)
    y, ld = layer.inverse(params, z)
    np.testing.assert_allclose(np.asarray(y), np.asarray(z), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-4)


def test_image_prior_lookup_and_sampling():
    from flowstate.flows import ImagePrior
    img = np.zeros((8, 8))
    img[0:4, 4:8] = 1.0  # bright top-right quadrant (rows = y from top)
    prior = ImagePrior(img, x_range=(-1.0, 1.0), y_range=(-1.0, 1.0))
    z = jnp.asarray([[0.9, 0.9], [-0.9, -0.9]])
    lp = prior.log_prob(z)
    assert lp.shape == (2,)
    # the bright quadrant has much higher density than the dark one
    assert float(lp[0]) - float(lp[1]) > 5.0
    s = prior.sample(jax.random.key(66), 200)
    assert s.shape == (200, 2)
    assert np.all(np.abs(np.asarray(s)) <= 1.0)
    # all accepted samples live in the bright quadrant (x>0, y>0)
    frac_bright = np.mean((np.asarray(s) > 0.0).all(axis=1))
    assert frac_bright > 0.95, frac_bright


def test_small_nn_utilities():
    from flowstate.flows import ClampExp, ConstScaleLayer, clamp_exp
    x = jnp.asarray([-2.0, 0.0, 3.0])
    np.testing.assert_allclose(
        np.asarray(clamp_exp(x)), [np.exp(-2.0), 1.0, 1.0], rtol=1e-6)
    assert ClampExp is clamp_exp
    np.testing.assert_allclose(
        np.asarray(ConstScaleLayer(2.5)(x)), np.asarray(x) * 2.5, rtol=1e-6)


def test_distances_from_vectors_matches_compute_distances():
    from flowstate.flows.utils import (
        compute_distances, distances_from_vectors)
    x = _rand(67, (8, 3 * 2))
    conf = x.reshape(8, 3, 2)
    rij = conf[:, :, None, :] - conf[:, None, :, :]
    dmat = distances_from_vectors(rij, eps=0.0)
    iu, ju = np.triu_indices(3, k=1)
    np.testing.assert_allclose(
        np.asarray(dmat[:, iu, ju]),
        np.asarray(compute_distances(x, 3, 2)), atol=1e-5)
