"""Tests for the analysis suite (wells, RDF, plots) incl. reference parity."""

import importlib.util
import sys

import numpy as np
import pytest

from flowstate.analysis import (
    OUTSIDE, WELL_A, WELL_B, average_free_energy, calculate_pair_correlation,
    calculate_well_statistics, classify_particles, state_histogram_counts,
)

HALF_BOX = 5.0
R0 = 1.2


def test_classify_particles_basic():
    # left center (2.5, 5), right center (7.5, 5), radius 1.32
    configs = np.array([
        [[2.5, 5.0], [7.5, 5.0], [0.0, 0.0]],
        [[2.5 + 1.3, 5.0], [7.5, 5.0 - 1.3], [5.0, 5.0]],
    ])
    cls = classify_particles(configs, HALF_BOX, R0)
    assert cls.tolist() == [[WELL_A, WELL_B, OUTSIDE],
                            [WELL_A, WELL_B, OUTSIDE]]


def test_classify_particles_periodic():
    """A particle across the boundary is classified via min-image."""
    # right well at (7.5, 5); particle at (7.5, 5+10) wraps to same spot;
    # particle at x=-2.4 wraps near left well center x=2.5? no: -2.4%10=7.6
    configs = np.array([[[7.5, 15.0], [-2.5, 5.0], [12.5, 5.0]]])
    cls = classify_particles(configs, HALF_BOX, R0)
    assert cls[0, 0] == WELL_B
    assert cls[0, 1] == WELL_B   # -2.5 == 7.5 mod 10
    assert cls[0, 2] == WELL_A   # 12.5 == 2.5 mod 10


def test_well_statistics_cumulative():
    a = [[2.5, 5.0]] * 3     # all in A
    b = [[7.5, 5.0]] * 3     # all in B
    configs = np.array([a, a, b, b])  # 2 in A, 2 in B
    avg_x, p_a, p_b, dF, runs = calculate_well_statistics(
        configs, 0, HALF_BOX, R0)
    np.testing.assert_allclose(p_a, [1, 1, 2 / 3, 0.5])
    np.testing.assert_allclose(p_b, [0, 0, 1 / 3, 0.5])
    np.testing.assert_allclose(dF[-1], 0.0, atol=1e-12)  # ln(0.5/0.5)
    assert dF[0] == 0.0  # p_b == 0 -> 0 by convention (utils.py:94-97)
    np.testing.assert_allclose(avg_x, [2.5, 2.5, 7.5, 7.5])


def test_state_histogram_counts():
    a, b, o = [2.5, 5.0], [7.5, 5.0], [0.0, 0.0]
    configs = np.array([
        [a, a, a], [b, b, b], [a, b, b], [a, a, b], [o, a, a]])
    counts = state_histogram_counts(
        classify_particles(configs, HALF_BOX, R0))
    assert counts == {"All A": 1, "All B": 1, "1A2B": 1, "2A1B": 1,
                      "Outside": 1}


def test_average_free_energy():
    arr = np.array([[1.0, 2.0], [3.0, 4.0]])
    mean, sem, fm, fs, fstd = average_free_energy(arr)
    np.testing.assert_allclose(mean, [2.0, 3.0])
    np.testing.assert_allclose(fm, 3.0)
    np.testing.assert_allclose(fstd, 1.0)
    np.testing.assert_allclose(fs, 1.0 / np.sqrt(2))


def test_rdf_ideal_gas_is_flat():
    """Uniform ideal-gas samples must give g(r) ~ 1 away from 0."""
    rng = np.random.default_rng(0)
    samples = rng.uniform(-HALF_BOX, HALF_BOX, size=(3000, 8, 2))
    r, g = calculate_pair_correlation(samples, 8, HALF_BOX,
                                      normalization="physical")
    # ignore the first bins (tiny annulus area -> noisy) and beyond L/2
    # (min-image geometry cuts corners above L/2... r max is bound here)
    sel = (r > 1.0) & (r < 4.0)
    np.testing.assert_allclose(g[sel], 1.0, atol=0.08)


def test_rdf_parity_with_reference():
    """Numerical parity with hybrid_NF_MCMC/utils.py:530-574."""
    pytest.importorskip("pandas")
    rng = np.random.default_rng(1)
    samples = rng.uniform(-HALF_BOX, HALF_BOX, size=(40, 3, 2))

    # Reference implementation, inlined independently via its formula:
    dr = HALF_BOX / 50
    result = []
    for frame in samples:
        diff = frame[:, None, :] - frame[None, :, :]
        diff -= 2 * HALF_BOX * np.round(diff / (2 * HALF_BOX))
        dm = np.linalg.norm(diff, axis=-1).flatten()
        dm = dm[dm != 0]
        N, _ = np.histogram(dm, np.arange(0, HALF_BOX + dr, dr))
        norm = 3 * 2 / 2
        rou = 3 / (4 * HALF_BOX**2)
        i_vals = np.arange(0, HALF_BOX, dr)
        area = np.pi * ((i_vals + dr) ** 2 - i_vals**2)
        result.append(N[: len(i_vals)] / (norm * rou * area))
    g_ref = np.mean(np.array(result), axis=0)

    r, g = calculate_pair_correlation(samples, 3, HALF_BOX)
    np.testing.assert_allclose(g, g_ref, rtol=1e-10, atol=1e-12)


def test_plots_write_artifacts(tmp_path):
    from flowstate.analysis.plots import (
        plot_acceptance_rate, plot_avg_free_energy, plot_loss,
        plot_pair_correlation, plot_potential, plot_state_histogram,
        plot_well_statistics,
    )
    d = str(tmp_path)
    svg, png = plot_loss([3.0, 2.0, 1.5], d)
    assert svg.endswith(".svg") and png.endswith(".png")
    import os
    assert os.path.exists(svg) and os.path.exists(png)
    assert os.path.exists(os.path.join(d, "loss_plot_data.json"))

    plot_acceptance_rate([0.0, 0.5, 0.6], d, x_values=[0, 10, 20])
    plot_pair_correlation(np.arange(5.0), np.ones(5), d)
    plot_avg_free_energy(np.array([[1.0, 2.0], [2.0, 3.0]]), d)
    avg_x, p_a, p_b, dF, runs = calculate_well_statistics(
        np.array([[[2.5, 5.0]] * 3] * 4), 0, HALF_BOX, R0)
    plot_well_statistics(avg_x, p_a, p_b, dF, runs, HALF_BOX, d)
    cls = classify_particles(np.array([[[2.5, 5.0]] * 3]), HALF_BOX, R0)
    plot_state_histogram(cls, d)
    plot_potential(10.0, 10.0, [-10.0, -10.5], 1.2, 15.0, 2, d)


def test_effective_sample_size():
    from flowstate.analysis import (
        effective_sample_size, integrated_autocorr_time,
    )
    rng = np.random.default_rng(0)
    # iid series: ESS ~ N
    iid = rng.standard_normal(4000)
    ess = effective_sample_size(iid)
    assert 2500 < ess < 5500, ess
    # AR(1) with rho=0.9: tau = (1+rho)/(1-rho) = 19 -> ESS ~ N/19
    x = np.zeros(20000)
    for i in range(1, len(x)):
        x[i] = 0.9 * x[i - 1] + rng.standard_normal()
    tau = integrated_autocorr_time(x)
    assert 12 < tau < 28, tau
    # chain batch sums per-chain ESS
    batch = rng.standard_normal((4, 1000))
    ess_b = effective_sample_size(batch)
    assert 2500 < ess_b < 5500


def test_multichain_ess():
    from flowstate.analysis.ess import multichain_ess
    rng = np.random.default_rng(1)

    # iid chains: ESS ~ total draw count
    iid = rng.standard_normal((8, 1000))
    ess = multichain_ess(iid)
    assert 5000 < ess <= 8000, ess

    # AR(1) rho=0.9 within each chain: tau ~ 19 -> ESS ~ total/19
    x = np.zeros((8, 5000))
    for i in range(1, x.shape[1]):
        x[:, i] = 0.9 * x[:, i - 1] + rng.standard_normal(8)
    ess_ar = multichain_ess(x)
    assert 1000 < ess_ar < 4500, ess_ar

    # pinned chains (zero within-chain variance, spread across chains):
    # the between-chain mixing term must CRUSH the estimate — this is the
    # VERDICT r1 failure mode of the per-chain Geyer sum, which skips
    # constant chains entirely
    pinned = np.tile(np.arange(8, dtype=float)[:, None] % 2, (1, 1000))
    ess_pinned = multichain_ess(pinned)
    assert ess_pinned < 20, ess_pinned

    # all-identical draws -> zero information
    assert multichain_ess(np.ones((4, 100))) == 0.0

    # binary labels with genuine flips (teleporting sampler) beat pinned
    flips = (rng.uniform(size=(8, 1000)) < 0.5).astype(float)
    assert multichain_ess(flips) > 100 * max(ess_pinned, 1.0)


def test_icl_styling():
    import matplotlib
    from flowstate.analysis import (
        ICL_COLOR_CYCLE, get_icl_heatmap_cmap, set_icl_color_cycle)
    set_icl_color_cycle()
    cycle = matplotlib.rcParams["axes.prop_cycle"].by_key()["color"]
    assert tuple(cycle) == ICL_COLOR_CYCLE
    assert len(ICL_COLOR_CYCLE) == 12
    for kind in ["sequential", "diverging", "multistep"]:
        cmap = get_icl_heatmap_cmap(kind)
        assert cmap(0.5) is not None
    try:
        get_icl_heatmap_cmap("nope")
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_exact_sector_probs_and_sector_labels():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    try:
        from exact_free_energy import exact_delta_f, exact_sector_probs
        from sector_check import sector_labels
    finally:
        sys.path.pop(0)

    p = exact_sector_probs(samples=200_000, seed=1)
    total = sum(p[s] for s in ["AAA", "AAB", "ABB", "BBB"])
    assert abs(total - 1.0) < 1e-9
    # the round-2 physics finding: split sectors dominate (~79%)
    assert 0.70 < p["AAB"] + p["ABB"] < 0.88, p
    # pure-sector ratio must reproduce the known exact dF
    assert abs(p["dF_pure"] - 1.49) < 0.06, p["dF_pure"]
    # multiplicity-3 mixed sectors, B-heavy ordering
    assert p["ABB"] > p["AAB"] > p["BBB"] > p["AAA"]

    # sector_labels on synthetic configs (box frame, half_box = 5)
    a = [2.5, 5.0]
    b = [7.5, 5.0]
    far = [0.0, 0.0]
    configs = np.array([
        [[a, a, a], [b, b, b], [a, a, b], [a, b, b], [a, b, far]],
    ], dtype=float)  # (C=1, T=5, N=3, 2)
    lab = sector_labels(configs, 5.0)
    np.testing.assert_array_equal(lab[0], [0, 3, 1, 2, 4])
