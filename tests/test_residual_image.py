"""Tests for residual flows, image (Glow) components, and multiscale models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import (
    ActNormImage, ClassCondFlow, ConvNet2d, DiagGaussian, GlowBlock,
    LipschitzMLP, Merge, MultiscaleFlow, Residual, UniformBase,
)

D = 4


def test_lipschitz_mlp_is_contractive():
    net = LipschitzMLP((D, 32, D), coeff=0.9)
    params = net.init_params(jax.random.key(0))
    params = net.update_lipschitz(params, n_iterations=20)
    x = jax.random.normal(jax.random.key(1), (64, D))
    y = jax.random.normal(jax.random.key(2), (64, D))
    fx, fy = net.apply(params, x), net.apply(params, y)
    ratios = (np.linalg.norm(np.asarray(fx - fy), axis=1)
              / np.linalg.norm(np.asarray(x - y), axis=1))
    assert np.all(ratios < 1.0), ratios.max()


def test_residual_roundtrip_and_exact_logdet():
    net = LipschitzMLP((D, 32, D), coeff=0.9)
    layer = Residual(net, reverse=True, estimator="exact", dim=D)
    params = layer.init_params(jax.random.key(3))
    params = {"net": net.update_lipschitz(params["net"], 20)}
    z = jax.random.normal(jax.random.key(4), (8, D))
    y, ld = layer.forward(params, z)
    z_back, ld_inv = layer.inverse(params, y)
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-3)

    # exact log-det vs autodiff Jacobian of x -> x + g(x)
    def f(v):
        out, _ = layer.inverse(params, v[None])  # inverse applies x + g(x)
        return out[0]

    J = jax.jacfwd(f)(z[0])
    _, exact = np.linalg.slogdet(np.asarray(J))
    _, ld_i = layer.inverse(params, z[:1])
    np.testing.assert_allclose(float(ld_i[0]), exact, atol=1e-4)


def test_residual_series_estimator_close_to_exact():
    net = LipschitzMLP((D, 32, D), coeff=0.7)
    params_net = net.update_lipschitz(
        net.init_params(jax.random.key(5)), 20)
    exact_layer = Residual(net, estimator="exact", dim=D)
    series_layer = Residual(net, estimator="series", n_power_series=20,
                            n_trace_samples=64)
    params = {"net": params_net}
    z = jax.random.normal(jax.random.key(6), (16, D))
    _, ld_e = exact_layer.inverse(params, z)
    _, ld_s = series_layer.inverse(params, z)
    np.testing.assert_allclose(np.asarray(ld_s), np.asarray(ld_e), atol=0.1)


def test_convnet2d_shapes():
    net = ConvNet2d((2, 8, 8, 4), kernel_size=(3, 1, 3))
    params = net.init_params(jax.random.key(7))
    x = jax.random.normal(jax.random.key(8), (3, 2, 8, 8))
    y = net.apply(params, x)
    assert y.shape == (3, 4, 8, 8)
    # zero-init final conv -> zero output at init
    np.testing.assert_allclose(np.asarray(y), 0.0, atol=1e-6)


def test_glow_block_roundtrip():
    layer = GlowBlock(channels=4, hidden_channels=8)
    params = layer.init_params(jax.random.key(9))
    z = jax.random.normal(jax.random.key(10), (2, 4, 4, 4))
    y, ld = layer.forward(params, z)
    z_back, ld_inv = layer.inverse(params, y)
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-4)


def test_actnorm_image_data_init():
    an = ActNormImage(3)
    z = 2.0 + 1.5 * jax.random.normal(jax.random.key(11), (64, 3, 5, 5))
    params = an.init_params_from_data(z)
    y, _ = an.forward(params, z)
    np.testing.assert_allclose(np.asarray(y).mean(axis=(0, 2, 3)), 0.0,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(y).std(axis=(0, 2, 3)), 1.0,
                               atol=1e-2)


class _CondBase:
    """Base whose log_prob shifts with the class label (one-hot y)."""

    def __init__(self, dim, num_classes):
        self.dim = dim
        self.inner = DiagGaussian(dim, trainable=False)
        self.num_classes = num_classes

    def log_prob(self, z, y):
        shift = y @ jnp.arange(self.num_classes, dtype=jnp.float32)[:, None]
        return self.inner.log_prob(z - shift)

    def sample(self, key, n, y):
        shift = y @ jnp.arange(self.num_classes, dtype=jnp.float32)[:, None]
        return self.inner.sample(key, n) + shift


def test_class_cond_flow():
    from flowstate.flows import AffineConstFlow
    base = _CondBase(D, 3)
    model = ClassCondFlow(base, (AffineConstFlow(D),))
    params = model.init_params(jax.random.key(12))
    x = jax.random.normal(jax.random.key(13), (6, D))
    y = jax.nn.one_hot(jnp.array([0, 1, 2, 0, 1, 2]), 3)
    lp = model.log_prob(params, x, y)
    assert lp.shape == (6,)
    loss = model.forward_kld(params, x, y)
    assert np.isfinite(float(loss))
    s = model.sample(params, jax.random.key(14), 6, y)
    assert s.shape == (6, D)


def test_multiscale_flow_roundtrip():
    from flowstate.flows import AffineConstFlow
    d = 8
    bases = (DiagGaussian(d // 2, trainable=False),
             DiagGaussian(d // 2, trainable=False))
    flows = ((AffineConstFlow(d // 2),), (AffineConstFlow(d),))
    merges = (Merge(mode="channel"),)
    model = MultiscaleFlow(bases=bases, flows=flows, merges=merges)
    params = model.init_params(jax.random.key(15))
    x = jax.random.normal(jax.random.key(16), (5, d))
    z_list, ld = model.inverse_and_log_det(params, x)
    assert len(z_list) == 2
    x_back, ld_fwd = model.forward_and_log_det(params, z_list)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ld + ld_fwd), 0.0, atol=1e-5)
    lp = model.log_prob(params, x)
    assert np.all(np.isfinite(np.asarray(lp)))
    s = model.sample(params, jax.random.key(17), 10)
    assert s.shape == (10, d)


def test_lipschitz_cnn_contractive():
    from flowstate.flows import LipschitzCNN
    net = LipschitzCNN(channels=(2, 8, 2), kernel_size=(3, 3),
                       spatial=(6, 6), coeff=0.9)
    params = net.init_params(jax.random.key(40))
    params = net.update_lipschitz(params, n_iterations=20)
    x = jax.random.normal(jax.random.key(41), (4, 2, 6, 6))
    y = jax.random.normal(jax.random.key(42), (4, 2, 6, 6))
    fx, fy = net.apply(params, x), net.apply(params, y)
    num = np.linalg.norm(np.asarray(fx - fy).reshape(4, -1), axis=1)
    den = np.linalg.norm(np.asarray(x - y).reshape(4, -1), axis=1)
    assert np.all(num / den < 1.0)


def test_residual_unbiased_estimator_mean_close_to_exact():
    """Russian-roulette estimator is unbiased: key-averaged value ≈ exact."""
    net = LipschitzMLP((D, 32, D), coeff=0.6)
    params_net = net.update_lipschitz(
        net.init_params(jax.random.key(7)), 20)
    params = {"net": params_net}
    exact_layer = Residual(net, estimator="exact", dim=D)
    z = jax.random.normal(jax.random.key(8), (4, D))
    _, ld_exact = exact_layer.inverse(params, z)

    unb = Residual(net, estimator="unbiased", n_power_series=24,
                   n_trace_samples=4, n_exact_terms=2, geom_p=0.5)
    keys = jax.random.split(jax.random.key(9), 256)
    lds = jax.vmap(lambda k: unb._logdet_unbiased(params, z, k))(keys)
    mean_ld = np.asarray(jnp.mean(lds, axis=0))
    np.testing.assert_allclose(mean_ld, np.asarray(ld_exact), atol=0.05)

    # poisson roulette agrees too
    unb_p = Residual(net, estimator="unbiased", n_dist="poisson",
                     n_power_series=24, n_trace_samples=4,
                     n_exact_terms=2, lamb=2.0)
    lds_p = jax.vmap(lambda k: unb_p._logdet_unbiased(params, z, k))(keys)
    np.testing.assert_allclose(np.asarray(jnp.mean(lds_p, axis=0)),
                               np.asarray(ld_exact), atol=0.05)


def test_roulette_distribution_helpers():
    from flowstate.flows import geometric_sample, poisson_sample
    from flowstate.flows.residual import geometric_1mcdf, poisson_1mcdf
    g = np.asarray(geometric_sample(jax.random.key(10), 0.5, (4000,)))
    assert g.min() >= 1
    assert abs(g.mean() - 2.0) < 0.15          # E[Geom(0.5)] = 1/p = 2
    p = np.asarray(poisson_sample(jax.random.key(11), 2.0, (4000,)))
    assert abs(p.mean() - 2.0) < 0.15
    # 1 - CDF values vs direct calculation, incl. the offset convention
    assert geometric_1mcdf(0.5, 2, 2) == 1.0
    np.testing.assert_allclose(geometric_1mcdf(0.5, 5, 2), 0.25)
    np.testing.assert_allclose(poisson_1mcdf(2.0, 4, 2),
                               1.0 - np.exp(-2.0) * (1 + 2.0), rtol=1e-6)


def test_batch_jacobian_trace_helpers():
    from flowstate.flows import batch_jacobian, batch_trace
    w = jax.random.normal(jax.random.key(12), (D, D))
    x = jax.random.normal(jax.random.key(13), (3, D))
    jac = batch_jacobian(lambda v: jnp.tanh(v @ w), x)
    assert jac.shape == (3, D, D)
    sech2 = 1.0 - np.tanh(np.asarray(x) @ np.asarray(w)) ** 2
    np.testing.assert_allclose(np.asarray(batch_trace(jac)),
                               np.einsum("bd,dd->b", sech2,
                                         np.asarray(w) * np.eye(D)),
                               atol=1e-5)


def test_conv_residual_net_shapes_and_near_identity_blocks():
    from flowstate.flows import ConvResidualNet
    net = ConvResidualNet(in_channels=2, out_channels=5, hidden_channels=8,
                          num_blocks=2)
    params = net.init_params(jax.random.key(14))
    x = jax.random.normal(jax.random.key(15), (3, 2, 6, 6))
    y = net.apply(params, x)
    assert y.shape == (3, 5, 6, 6)
    # zero-initialized second conv makes each block ≈ identity at init:
    # the output equals final(initial(x)) to first order
    direct = net.apply(
        {**params, "blocks": [
            {**b, "c2": {"w": jnp.zeros_like(b["c2"]["w"]),
                         "b": jnp.zeros_like(b["c2"]["b"])}}
            for b in params["blocks"]]}, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(direct), atol=0.05)


def test_lipschitz_activations():
    from flowstate.flows import asym_squash, leaky_elu
    x = jnp.linspace(-5.0, 5.0, 101)
    le = np.asarray(leaky_elu(x))
    # matches the closed form a*x + (1-a)*elu(x)
    np.testing.assert_allclose(
        le, 0.3 * np.asarray(x) + 0.7 * np.asarray(jax.nn.elu(x)), atol=1e-6)
    sq = np.asarray(asym_squash(x))
    assert np.all((sq > 1.0) & (sq < 5.0))
    assert np.all(np.diff(sq) > 0)  # monotone


def test_residual_unbiased_requires_key_through_public_api():
    net = LipschitzMLP((D, 16, D), coeff=0.6)
    layer = Residual(net, estimator="unbiased", n_power_series=8)
    params = layer.init_params(jax.random.key(20))
    z = jax.random.normal(jax.random.key(21), (2, D))
    try:
        layer.inverse(params, z)
        raise AssertionError("expected ValueError without a key")
    except ValueError:
        pass
    _, ld = layer.inverse(params, z, key=jax.random.key(22))
    assert np.all(np.isfinite(np.asarray(ld)))
    try:
        Residual(net, estimator="nope").inverse(params, z)
        raise AssertionError("expected ValueError for unknown estimator")
    except ValueError:
        pass


def test_conditional_normalizing_flow_end_to_end():
    """ConditionalNormalizingFlow with context-capable couplings: round-trip,
    context-dependent density, conditional sampling."""
    from flowstate.flows import (
        ConditionalNormalizingFlow, ContextAffineCoupling)
    from flowstate.flows.toy_targets import ConditionalDiagGaussian

    d = 4
    ctx_w = 2 * d  # loc + scale for the conditional base
    layers = (ContextAffineCoupling(d, ctx_w, flip=False),
              ContextAffineCoupling(d, ctx_w, flip=True))
    model = ConditionalNormalizingFlow(ConditionalDiagGaussian(), layers)
    params = model.init_params(jax.random.key(30))

    b = 8
    loc = jax.random.normal(jax.random.key(31), (b, d))
    ctx = jnp.concatenate([loc, jnp.full((b, d), 0.7)], axis=-1)
    z = jax.random.normal(jax.random.key(32), (b, d))

    y, ld = model.forward_and_log_det(params, z, context=ctx)
    z_back, ld_inv = model.inverse_and_log_det(params, y, context=ctx)
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-4)

    # density responds to the context
    lp1 = model.log_prob(params, z, context=ctx)
    lp2 = model.log_prob(params, z, context=ctx.at[:, :d].add(3.0))
    assert np.all(np.isfinite(np.asarray(lp1)))
    assert not np.allclose(np.asarray(lp1), np.asarray(lp2))

    # conditional sampling tracks the context mean (zero-init couplings
    # start near identity up to the sigmoid scale map's 0.88 factor)
    big_ctx = jnp.tile(jnp.concatenate([loc[:1], 0.1 * jnp.ones((1, d))],
                                       axis=-1), (256, 1))
    s = model.sample(params, jax.random.key(33), 256, context=big_ctx)
    np.testing.assert_allclose(np.asarray(s.mean(axis=0)),
                               np.asarray(loc[0]), atol=0.35)
    assert float(np.corrcoef(np.asarray(s.mean(axis=0)),
                             np.asarray(loc[0]))[0, 1]) > 0.99

    # forward_kld is finite
    assert np.isfinite(float(model.forward_kld(params, z, context=ctx)))
