"""Unit tests for potentials vs closed-form values and reference semantics."""

import jax.numpy as jnp
import numpy as np

from flowstate.ops import (
    double_well_potential, double_well_potential_equal, gaussian_double_well,
    lennard_jones_energy_virial, lennard_jones_force,
    tail_correction_energy_2d, tail_correction_pressure_2d,
)


def _lj_unshifted(r):
    sr6 = (1.0 / r) ** 6
    return 4.0 * (sr6 * sr6 - sr6)


def test_lj_closed_form_values():
    e, w = lennard_jones_energy_virial(jnp.array([1.0, 2.0**(1 / 6), 2.0]))
    shift = _lj_unshifted(2.5)
    # r=1: 4(1-1)=0 minus shift
    np.testing.assert_allclose(float(e[0]), 0.0 - shift, rtol=1e-5)
    # r = 2^(1/6): the LJ minimum, -1 minus shift
    np.testing.assert_allclose(float(e[1]), -1.0 - shift, rtol=1e-5)
    np.testing.assert_allclose(float(e[2]), _lj_unshifted(2.0) - shift, rtol=1e-5)
    # virial at the minimum is zero: 48(sr12 - 0.5 sr6) with sr6 = 1/2
    np.testing.assert_allclose(float(w[1]), 0.0, atol=1e-4)


def test_lj_cutoff_and_shift():
    e, w = lennard_jones_energy_virial(jnp.array([2.5, 2.5001, 3.0]))
    # exactly at cutoff: energy = 0 by the shift
    np.testing.assert_allclose(float(e[0]), 0.0, atol=1e-6)
    assert float(e[1]) == 0.0 and float(e[2]) == 0.0
    assert float(w[1]) == 0.0 and float(w[2]) == 0.0
    e_ns, _ = lennard_jones_energy_virial(jnp.array([2.0]), shift=False)
    np.testing.assert_allclose(float(e_ns[0]), _lj_unshifted(2.0), rtol=1e-5)


def test_lj_force():
    f = lennard_jones_force(jnp.array([2.0**(1 / 6), 3.0, 0.0]))
    np.testing.assert_allclose(float(f[0]), 0.0, atol=1e-4)  # zero at minimum
    assert float(f[1]) == 0.0  # beyond cutoff
    assert float(f[2]) == 0.0  # r=0 masked (reference potential.py:42)


def test_tail_corrections_match_reference_formulas():
    rho, n, rc = 0.3, 10, 2.5
    e = float(tail_correction_energy_2d(rho, n, rc))
    expected = (8 * np.pi * rho * n) * (1 / (10 * rc**10) - 1 / (4 * rc**4))
    np.testing.assert_allclose(e, expected, rtol=1e-6)
    p = float(tail_correction_pressure_2d(rho, rc))
    expected_p = (24 * np.pi * rho**2) * (1 / (5 * rc**10) - 1 / (4 * rc**4))
    np.testing.assert_allclose(p, expected_p, rtol=1e-6)


def test_double_well_depths_at_centers():
    lx, ly = 10.0, 10.0
    v0 = [-10.0, -10.5]
    r0, k = 1.2, 15.0
    # at left well center: V ~ V0[0] (far-well contribution negligible)
    v_left = float(double_well_potential(jnp.array([lx / 4, ly / 2]), lx, ly,
                                         V0_list=v0, r0=r0, k=k))
    v_right = float(double_well_potential(jnp.array([3 * lx / 4, ly / 2]), lx,
                                          ly, V0_list=v0, r0=r0, k=k))
    np.testing.assert_allclose(v_left, v0[0], atol=1e-3)
    np.testing.assert_allclose(v_right, v0[1], atol=1e-3)
    # far from both wells: ~0
    v_far = float(double_well_potential(jnp.array([0.0, 0.0]), lx, ly,
                                        V0_list=v0, r0=r0, k=k))
    np.testing.assert_allclose(v_far, 0.0, atol=1e-2)


def test_double_well_transition_midpoint():
    """At r = r0 from a center, transition = 0.5 -> V = V0/2 per well."""
    lx = ly = 10.0
    v = float(double_well_potential(jnp.array([lx / 4 + 1.2, ly / 2]), lx, ly,
                                    V0_list=[-10.0, 0.0], r0=1.2, k=15.0,
                                    num_wells=2))
    np.testing.assert_allclose(v, -5.0, atol=1e-2)


def test_double_well_periodicity():
    lx, ly = 10.0, 10.0
    p = jnp.array([1.3, 2.7])
    v1 = float(double_well_potential(p, lx, ly, V0_list=[-10, -10.5],
                                     r0=1.2, k=15))
    v2 = float(double_well_potential(p + jnp.array([lx, -ly]), lx, ly,
                                     V0_list=[-10, -10.5], r0=1.2, k=15))
    np.testing.assert_allclose(v1, v2, rtol=1e-5)


def test_double_well_batched_shapes():
    lx = ly = 10.0
    pts = jnp.zeros((7, 3, 2))
    v = double_well_potential(pts, lx, ly)
    assert v.shape == (7, 3)


def test_double_well_default_depths():
    """V0_list=None -> [-4.0]*num_wells (reference potential.py:80-81)."""
    lx = ly = 10.0
    v = float(double_well_potential(jnp.array([lx / 4, ly / 2]), lx, ly))
    np.testing.assert_allclose(v, -4.0, atol=1e-3)
    v_eq = float(double_well_potential_equal(jnp.array([lx / 4, ly / 2]),
                                             lx, ly, V0=-2.0))
    np.testing.assert_allclose(v_eq, -2.0, atol=1e-3)


def test_gaussian_double_well():
    lx = ly = 10.0
    v = float(gaussian_double_well(jnp.array([lx / 4, ly / 2]), lx, ly,
                                   V0=-0.5, a=5.0))
    # exp(0) at the left center, negligible from the right well
    np.testing.assert_allclose(v, -0.5, atol=1e-6)


def test_reference_potential_parity():
    """Direct numerical parity vs /root/reference/MCMC/potential.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ref_potential", "/root/reference/MCMC/potential.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    rng = np.random.default_rng(0)
    r = rng.uniform(0.6, 3.5, size=200)
    e_ref, w_ref = ref.lennard_jones_energy_virial(r)
    e, w = lennard_jones_energy_virial(jnp.asarray(r))
    np.testing.assert_allclose(np.asarray(e), e_ref, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(w), w_ref, rtol=2e-4, atol=1e-5)

    pos = rng.uniform(-5, 15, size=(50, 2))
    v_ref = ref.double_well_potential(pos, 10.0, 10.0,
                                      V0_list=[-10.0, -10.5], r0=1.2, k=15.0)
    v = double_well_potential(jnp.asarray(pos), 10.0, 10.0,
                              V0_list=[-10.0, -10.5], r0=1.2, k=15.0)
    np.testing.assert_allclose(np.asarray(v), v_ref, rtol=1e-4, atol=1e-5)
