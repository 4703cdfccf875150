"""MBAR estimator tests: analytic free energies, reweighted expectations,
and the PT + MBAR pipeline vs the exact quadrature oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis.mbar import (
    mbar_expectation, mbar_free_energies, mbar_log_weights, pt_well_delta_f,
)
from flowstate.mcmc import (
    init_tempered_state, run_replica_exchange, temperature_ladder,
)
from flowstate.ops import Box, SystemSpec
from flowstate.ops.potentials import double_well_potential


def _gaussian_ladder(sigmas, m, seed=0):
    """Samples + reduced potentials for 1D Gaussians u_k = x^2/(2 s_k^2).

    Exact dimensionless free energies: f_k = -ln(s_k / s_0).
    """
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.normal(0, s, m) for s in sigmas])
    u_kn = np.stack([xs**2 / (2 * s**2) for s in sigmas])
    n_k = np.full(len(sigmas), m)
    return xs, u_kn, n_k


def test_mbar_recovers_gaussian_free_energies():
    sigmas = [1.0, 0.7, 0.45, 0.3]
    m = 20000
    _, u_kn, n_k = _gaussian_ladder(sigmas, m)
    with jax.enable_x64(True):
        f = np.asarray(mbar_free_energies(jnp.asarray(u_kn),
                                          jnp.asarray(n_k)))
    exact = -np.log(np.asarray(sigmas) / sigmas[0])
    np.testing.assert_allclose(f, exact, atol=0.02)


def test_mbar_expectation_reweights_correctly():
    sigmas = [1.0, 0.5]
    m = 40000
    xs, u_kn, n_k = _gaussian_ladder(sigmas, m, seed=1)
    with jax.enable_x64(True):
        f = mbar_free_energies(jnp.asarray(u_kn), jnp.asarray(n_k))
        # <x^2> at state k is sigma_k^2, from the POOLED samples
        for k, s in enumerate(sigmas):
            ex2 = float(mbar_expectation(jnp.asarray(u_kn),
                                         jnp.asarray(n_k), f,
                                         jnp.asarray(xs**2), k))
            np.testing.assert_allclose(ex2, s**2, rtol=0.03)
        # weights normalize
        lw = mbar_log_weights(jnp.asarray(u_kn), jnp.asarray(n_k), f, 0)
        np.testing.assert_allclose(float(jnp.sum(jnp.exp(lw))), 1.0,
                                   rtol=1e-6)


def test_pt_mbar_delta_f_matches_quadrature():
    """MBAR over ALL replicas of a PT run reproduces the exact ΔF of the
    deep N=1 double well (same oracle as test_tempering.py) — pooling the
    ladder instead of keeping only the cold replica."""
    box = Box.from_density(1, 0.01, 1.0)
    spec = SystemSpec.create(1, box, num_wells=2, V0_list=(-6.0, -6.5),
                             r0=1.2, k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y

    g = 400
    xs = np.linspace(0, lx, g, endpoint=False) + lx / g / 2
    ys = np.linspace(0, ly, g, endpoint=False) + ly / g / 2
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    pts = jnp.asarray(np.stack([xx.ravel(), yy.ravel()], axis=-1))
    V = np.asarray(double_well_potential(pts, lx, ly,
                                         V0_list=list(spec.V0_list),
                                         r0=spec.r0, k=spec.k)).reshape(g, g)
    wgt = np.exp(-V)
    radius = 1.1 * spec.r0
    dA = np.hypot(xx - lx / 4, yy - ly / 2) <= radius
    dB = np.hypot(xx - 3 * lx / 4, yy - ly / 2) <= radius
    exact_dF = np.log(wgt[dB].sum() / wgt[dA].sum())

    betas = temperature_ladder(1.0, 6.0, 4)
    pos = np.tile(np.array([lx / 4, ly / 2], dtype=np.float32),
                  (4, 48, 1, 1))
    state = init_tempered_state(spec, jnp.asarray(pos), jax.random.key(8),
                                1.5)
    run = jax.jit(lambda s, k: run_replica_exchange(
        spec, betas, s, k, num_rounds=300, moves_per_round=25,
        record="all"))
    result = run(state, jax.random.key(9))

    burn = 100
    pos_all = np.asarray(result.cold_positions)[burn:]   # (T, R, W, 1, 2)
    e_all = np.asarray(result.cold_energy)[burn:]        # (T, R, W)
    t, r, w = e_all.shape
    # pool per replica: (R, T*W), row-major pooling matches indicators below
    energies = np.transpose(e_all, (1, 0, 2)).reshape(r, t * w)
    xy = np.transpose(pos_all, (1, 0, 2, 3, 4)).reshape(r * t * w, 2)
    in_a = np.hypot(*(xy - [lx / 4, ly / 2]).T) <= radius
    in_b = np.hypot(*(xy - [3 * lx / 4, ly / 2]).T) <= radius

    with jax.enable_x64(True):
        df, f_k = pt_well_delta_f(jnp.asarray(energies), betas,
                                  jnp.asarray(in_a), jnp.asarray(in_b))
    assert abs(df - exact_dF) < 0.25, (df, exact_dF)
    # ladder free energies are monotone (hotter state = lower beta*F)
    assert np.all(np.isfinite(np.asarray(f_k)))
