"""Tests for the rational-quadratic spline kernels.

Mirrors the reference test strategy (``NF/normflows/utils/splines_test.py``):
forward∘inverse ≈ identity with log-det antisymmetry — plus stronger oracles
the reference lacks: the log-det is checked against the autodiff derivative,
and circular tails are checked for matching boundary derivatives.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.ops import (
    rational_quadratic_spline, unconstrained_rational_quadratic_spline,
)
from flowstate.ops.splines import IDENTITY_DERIVATIVE_CONSTANT


def _params(rng, shape, num_bins, num_derivs):
    return (jnp.asarray(rng.normal(size=(*shape, num_bins))),
            jnp.asarray(rng.normal(size=(*shape, num_bins))),
            jnp.asarray(rng.normal(size=(*shape, num_derivs))))


def test_rq_spline_forward_inverse(rng):
    nb = 8
    uw, uh, ud = _params(rng, (100,), nb, nb + 1)
    x = jnp.asarray(rng.uniform(0.02, 0.98, size=(100,)))
    y, ld = rational_quadratic_spline(x, uw, uh, ud)
    x_back, ld_inv = rational_quadratic_spline(y, uw, uh, ud, inverse=True)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-4)


def test_rq_spline_monotone(rng):
    nb = 6
    uw, uh, ud = _params(rng, (), nb, nb + 1)
    x = jnp.linspace(0.01, 0.99, 200)
    y, _ = rational_quadratic_spline(
        x, jnp.broadcast_to(uw, (200, nb)), jnp.broadcast_to(uh, (200, nb)),
        jnp.broadcast_to(ud, (200, nb + 1)))
    assert np.all(np.diff(np.asarray(y)) > 0)


def test_rq_spline_logdet_matches_autodiff(rng):
    nb = 8
    uw, uh, ud = _params(rng, (), nb, nb + 1)

    def f(x):
        y, _ = rational_quadratic_spline(x, uw, uh, ud)
        return y

    xs = jnp.asarray(rng.uniform(0.05, 0.95, size=(50,)))
    grads = jax.vmap(jax.grad(f))(xs)
    _, ld = rational_quadratic_spline(
        xs, jnp.broadcast_to(uw, (50, nb)), jnp.broadcast_to(uh, (50, nb)),
        jnp.broadcast_to(ud, (50, nb + 1)))
    np.testing.assert_allclose(np.asarray(ld), np.log(np.asarray(grads)),
                               atol=1e-4)


@pytest.mark.parametrize("tails,nd_off", [("linear", -1), ("circular", 0)])
def test_unconstrained_roundtrip(rng, tails, nd_off):
    nb, bound = 10, 3.0
    uw, uh, ud = _params(rng, (64,), nb, nb + nd_off)
    x = jnp.asarray(rng.uniform(-4.0, 4.0, size=(64,)))  # some outside
    y, ld = unconstrained_rational_quadratic_spline(
        x, uw, uh, ud, tails=tails, tail_bound=bound)
    x_back, ld_inv = unconstrained_rational_quadratic_spline(
        y, uw, uh, ud, tails=tails, tail_bound=bound, inverse=True)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=1e-4)
    # outside the interval: identity, zero log-det
    outside = np.abs(np.asarray(x)) > bound
    np.testing.assert_allclose(np.asarray(y)[outside],
                               np.asarray(x)[outside], atol=1e-6)
    np.testing.assert_allclose(np.asarray(ld)[outside], 0.0, atol=1e-6)


def test_mixed_tails_roundtrip(rng):
    """Per-dim tails list (the hybrid's configuration, wrapper.py:256-258):
    num_derivatives = num_bins + 1, circular dims tie last := first."""
    nb, bound, d = 8, 5.0, 6
    tails = ["circular"] * d
    uw, uh, ud = _params(rng, (32, d), nb, nb + 1)
    x = jnp.asarray(rng.uniform(-bound, bound, size=(32, d)))
    y, ld = unconstrained_rational_quadratic_spline(
        x, uw, uh, ud, tails=tails, tail_bound=bound)
    x_back, ld_inv = unconstrained_rational_quadratic_spline(
        y, uw, uh, ud, tails=tails, tail_bound=bound, inverse=True)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=2e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=2e-4)
    assert np.all(np.abs(np.asarray(y)) <= bound + 1e-5)


def test_circular_boundary_derivative_continuity(rng):
    """Circular tails: slope at -bound equals slope at +bound."""
    nb, bound = 8, 2.0
    uw, uh, ud = _params(rng, (), nb, nb)

    def f(x):
        y, _ = unconstrained_rational_quadratic_spline(
            x, uw, uh, ud, tails="circular", tail_bound=bound)
        return y

    with jax.enable_x64(True):
        g_left = float(jax.grad(f)(jnp.asarray(-bound + 1e-8, dtype=jnp.float64)))
        g_right = float(jax.grad(f)(jnp.asarray(bound - 1e-8, dtype=jnp.float64)))
    np.testing.assert_allclose(g_left, g_right, rtol=1e-4)


def test_identity_init():
    """Zero widths/heights + IDENTITY_DERIVATIVE_CONSTANT derivs ≈ identity."""
    nb, bound = 16, 5.0
    shape = (40,)
    uw = jnp.zeros((*shape, nb))
    uh = jnp.zeros((*shape, nb))
    ud = jnp.full((*shape, nb), IDENTITY_DERIVATIVE_CONSTANT)
    x = jnp.linspace(-4.9, 4.9, 40)
    y, ld = unconstrained_rational_quadratic_spline(
        x, uw, uh, ud, tails="circular", tail_bound=bound)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ld), 0.0, atol=1e-4)


def test_reference_spline_parity(rng):
    """Numerical parity vs the reference torch implementation.

    The fork's list-tails path pads the derivative vector and ties a slot
    the spline never gathers (``splines.py:35-39`` catches lists because
    ``tails[0] == "circular"``), so its circular tie is a no-op; we match
    it with ``circular_tie=False`` (see ops/splines.py for the write-up).
    """
    torch = pytest.importorskip("torch")
    spec = importlib.util.spec_from_file_location(
        "ref_splines", "/root/reference/NF/normflows/utils/splines.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    nb, bound, d = 12, 5.0, 6
    uw = rng.normal(size=(33, d, nb)).astype(np.float64)
    uh = rng.normal(size=(33, d, nb)).astype(np.float64)
    ud = rng.normal(size=(33, d, nb + 1)).astype(np.float64)
    x = rng.uniform(-bound, bound, size=(33, d)).astype(np.float64)
    tails = ["circular"] * d

    y_ref, ld_ref = ref.unconstrained_rational_quadratic_spline(
        torch.tensor(x), torch.tensor(uw), torch.tensor(uh), torch.tensor(ud),
        inverse=False, tails=tails, tail_bound=bound)
    with jax.enable_x64(True):
        y, ld = unconstrained_rational_quadratic_spline(
            jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud),
            tails=tails, tail_bound=bound, circular_tie=False)
        np.testing.assert_allclose(np.asarray(y), y_ref.numpy(), atol=1e-8)
        np.testing.assert_allclose(np.asarray(ld), ld_ref.numpy(), atol=1e-8)

        y_i, ld_i = unconstrained_rational_quadratic_spline(
            jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh), jnp.asarray(ud),
            tails=tails, tail_bound=bound, inverse=True, circular_tie=False)
    y_ref_i, ld_ref_i = ref.unconstrained_rational_quadratic_spline(
        torch.tensor(x), torch.tensor(uw), torch.tensor(uh), torch.tensor(ud),
        inverse=True, tails=tails, tail_bound=bound)
    np.testing.assert_allclose(np.asarray(y_i), y_ref_i.numpy(), atol=1e-7)
    np.testing.assert_allclose(np.asarray(ld_i), ld_ref_i.numpy(), atol=1e-7)
