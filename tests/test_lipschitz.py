"""Induced p-norm Lipschitz layers (flows/lipschitz.py) vs exact operator
norms.

Reference surface: ``NF/normflows/nets/lipschitz.py:132-705``.  The tests
check the power iteration against CLOSED-FORM induced norms:

    ||W||_{1->q}   = max_j ||W[:, j]||_q      (column norms)
    ||W||_{p->inf} = max_i ||W[i, :]||_{p*}   (dual row norms)
    ||W||_{2->2}   = top singular value

and for convs against the explicit dense matrix of the conv operator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import (
    InducedNormCNN, InducedNormConv2d, InducedNormLinear, InducedNormMLP,
    asym_squash,
)


def _sigma(layer, params, iters=300):
    """Converged power-iteration estimate of the induced norm of w."""
    p = layer.update_lipschitz(params, n_iterations=iters)
    w = p["w"]
    if w.ndim == 2:
        return float(jnp.dot(p["u"], w @ p["v"]))
    c, (h, wid) = layer.in_channels, layer.spatial_dims
    wv = layer._conv(w, p["v"].reshape(1, c, h, wid)).reshape(-1)
    return float(jnp.dot(p["u"], wv))


@pytest.mark.parametrize("domain,codomain", [(2, 2), (1, 2), (2, np.inf),
                                             (1, np.inf), (1, 1)])
def test_linear_induced_norm_matches_closed_form(domain, codomain):
    layer = InducedNormLinear(6, 5, domain=domain, codomain=codomain,
                              coeff=0.9)
    params = layer.init_params(jax.random.key(0))
    w = np.asarray(params["w"])

    if (domain, codomain) == (2, 2):
        exact = np.linalg.svd(w, compute_uv=False)[0]
    elif domain == 1:
        q = codomain
        exact = max(np.linalg.norm(w[:, j], ord=q) for j in range(w.shape[1]))
    else:  # (2, inf): max dual(=2) row norm
        exact = max(np.linalg.norm(w[i, :], ord=2) for i in range(w.shape[0]))

    sigma = abs(_sigma(layer, params))
    # nonlinear power iteration is a lower bound that converges in practice
    assert sigma <= exact * 1.001
    assert sigma >= exact * 0.95, (sigma, exact)


def test_linear_soft_normalization_and_identity_below_coeff():
    # above coeff: normalized weight's spectral norm == coeff
    layer = InducedNormLinear(8, 8, coeff=0.5, bias=False)
    params = layer.init_params(jax.random.key(1))
    params["w"] = params["w"] * (2.0 / np.linalg.svd(
        np.asarray(params["w"]), compute_uv=False)[0])  # sigma = 2
    params = layer.update_lipschitz(params, n_iterations=200)
    w_n = np.asarray(layer.compute_weight(params))
    assert np.linalg.svd(w_n, compute_uv=False)[0] == pytest.approx(
        0.5, rel=1e-3)

    # below coeff: soft normalization leaves the weight untouched (ref :266)
    params["w"] = params["w"] * (0.2 / 2.0)
    params = layer.update_lipschitz(params, n_iterations=50)
    np.testing.assert_allclose(np.asarray(layer.compute_weight(params)),
                               np.asarray(params["w"]), rtol=1e-6)


def test_linear_apply_contracts():
    layer = InducedNormLinear(4, 4, coeff=0.8)
    params = layer.update_lipschitz(layer.init_params(jax.random.key(2)), 100)
    x = jax.random.normal(jax.random.key(3), (32, 4))
    y = jax.random.normal(jax.random.key(4), (32, 4))
    fx, fy = layer.apply(params, x), layer.apply(params, y)
    num = jnp.linalg.norm(fx - fy, axis=-1)
    den = jnp.linalg.norm(x - y, axis=-1)
    assert float(jnp.max(num / den)) <= 0.8 + 1e-5


def test_learnable_ord():
    layer = InducedNormLinear(5, 5, domain=0.0, codomain=0.0,
                              learnable_ord=True)
    params = layer.init_params(jax.random.key(5))
    # asym_squash maps raw orders into (1, 5); raw 0.0 -> ~2.09
    d = float(asym_squash(params["domain_raw"]))
    assert 1.0 < d < 5.0
    # gradient reaches the raw order scalars through compute_one_iter
    g = jax.grad(lambda p: layer.compute_one_iter(p))(params)
    assert np.isfinite(float(g["domain_raw"]))
    assert float(jnp.abs(g["domain_raw"])) + float(
        jnp.abs(g["codomain_raw"])) > 0.0
    # and NOT through the weight there (torch detaches it, ref :214-221)
    np.testing.assert_allclose(np.asarray(g["w"]), 0.0)


def test_conv_1x1_matches_matrix_spectral_norm():
    layer = InducedNormConv2d(3, 4, kernel_size=1, spatial_dims=(5, 5),
                              coeff=0.9)
    params = layer.init_params(jax.random.key(6))
    sigma = _sigma(layer, params)
    w_mat = np.asarray(params["w"]).reshape(4, 3)
    assert sigma == pytest.approx(np.linalg.svd(w_mat, compute_uv=False)[0],
                                  rel=1e-3)


def test_conv_3x3_matches_dense_operator_norm():
    h = w = 4
    layer = InducedNormConv2d(2, 3, kernel_size=3, spatial_dims=(h, w),
                              coeff=0.9)
    params = layer.init_params(jax.random.key(7))
    kern = params["w"]

    # materialize the conv operator column by column
    n_in = 2 * h * w
    eye = jnp.eye(n_in).reshape(n_in, 1, 2, h, w)
    cols = jax.vmap(lambda e: layer._conv(kern, e).reshape(-1))(eye)
    dense = np.asarray(cols).T                     # (n_out, n_in)
    exact = np.linalg.svd(dense, compute_uv=False)[0]

    sigma = _sigma(layer, params)
    assert sigma == pytest.approx(exact, rel=1e-3)

    # normalized operator norm respects coeff
    params = layer.update_lipschitz(params, 300)
    kern_n = layer.compute_weight(params)
    cols_n = jax.vmap(lambda e: layer._conv(kern_n, e).reshape(-1))(eye)
    top = np.linalg.svd(np.asarray(cols_n).T, compute_uv=False)[0]
    assert top <= 0.9 * 1.01


def test_induced_norm_mlp_is_contractive_and_trains():
    net = InducedNormMLP((3, 16, 3), coeff=0.9)
    params = net.init_params(jax.random.key(8))
    params = net.update_lipschitz(params, 100)

    x = jax.random.normal(jax.random.key(9), (64, 3))
    y = x + 0.1 * jax.random.normal(jax.random.key(10), (64, 3))
    ratio = (jnp.linalg.norm(net.apply(params, x) - net.apply(params, y),
                             axis=-1)
             / jnp.linalg.norm(x - y, axis=-1))
    assert float(jnp.max(ratio)) < 0.9 ** 2 + 1e-4  # two layers

    # last layer zero-init: its WEIGHT is scaled down 1000x (ref :199-201;
    # the bias keeps its kaiming bound, matching torch)
    assert float(jnp.max(jnp.abs(params[-1]["w"]))) < 1e-3
    assert float(jnp.max(jnp.abs(params[0]["w"]))) > 1e-2

    # gradients flow through apply
    g = jax.grad(lambda p: jnp.sum(net.apply(p, x) ** 2))(params)
    assert any(float(jnp.max(jnp.abs(layer_g["w"]))) > 0 for layer_g in g)


def test_induced_norm_mlp_as_residual_net():
    from flowstate.flows import Residual

    net = InducedNormMLP((2, 16, 2), coeff=0.9)
    block = Residual(net=net, reverse=False, estimator="exact", dim=2)
    params = {"net": net.update_lipschitz(net.init_params(jax.random.key(11)),
                                          50)}
    x = jax.random.normal(jax.random.key(12), (8, 2))
    y, ld = block.forward(params, x)
    x_rt, ld_inv = block.inverse(params, y)
    np.testing.assert_allclose(np.asarray(x_rt), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-4)


def test_induced_norm_cnn_forward():
    net = InducedNormCNN((2, 8, 2), kernel_size=(3, 3), spatial_dims=(6, 6),
                         coeff=0.9)
    params = net.init_params(jax.random.key(13))
    x = jax.random.normal(jax.random.key(14), (4, 2, 6, 6))
    y = net.apply(params, x)
    assert y.shape == (4, 2, 6, 6)
    params = net.update_lipschitz(params, 20)
    y2 = net.apply(params, x)
    assert np.all(np.isfinite(np.asarray(y2)))
