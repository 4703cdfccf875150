"""Unit tests for the periodic box kernels (flowstate/ops/box.py)."""

import jax.numpy as jnp
import numpy as np

from flowstate.ops import (
    Box, distance, distances_to_all, min_image, min_image_centered,
    pair_distance_matrix, upper_triangle_distances, wrap_pbc,
)


def test_box_from_density_matches_reference_formula():
    # reference initialise.py:145-148: area = N/rho, Lx = sqrt(area*AR)
    box = Box.from_density(3, 0.03, 1.0)
    assert np.isclose(box.size_x, 10.0)
    assert np.isclose(box.size_y, 10.0)
    assert np.isclose(box.volume, 100.0)

    box2 = Box.from_density(3, 0.03, 4.0)
    assert np.isclose(box2.size_x, 20.0)
    assert np.isclose(box2.size_y, 5.0)


def test_wrap_pbc():
    box = Box(10.0, 5.0)
    p = jnp.array([[12.5, -1.0], [-0.1, 5.0], [3.0, 2.0]])
    w = np.asarray(wrap_pbc(p, box))
    np.testing.assert_allclose(w, [[2.5, 4.0], [9.9, 0.0], [3.0, 2.0]],
                               atol=1e-6)


def test_min_image_wrap_cases():
    box = Box(10.0, 10.0)
    # delta of 6 wraps to -4; delta of -7 wraps to 3; exactly L/2 stays put
    d = jnp.array([[6.0, -7.0], [5.0, -5.0], [0.3, 0.0]])
    m = np.asarray(min_image(d, box))
    np.testing.assert_allclose(m[0], [-4.0, 3.0], atol=1e-6)
    # np.round uses banker's rounding: round(0.5) == 0, round(-0.5) == 0
    np.testing.assert_allclose(m[1], [5.0, -5.0], atol=1e-6)
    np.testing.assert_allclose(m[2], [0.3, 0.0], atol=1e-6)


def test_min_image_matches_numpy_reference_semantics(rng):
    """delta - L*round(delta/L) elementwise, as simulation_box.py:38-39."""
    box = Box(7.3, 4.1)
    deltas = rng.uniform(-20, 20, size=(100, 2))
    expected = deltas.copy()
    expected[:, 0] -= box.size_x * np.round(expected[:, 0] / box.size_x)
    expected[:, 1] -= box.size_y * np.round(expected[:, 1] / box.size_y)
    got = np.asarray(min_image(jnp.asarray(deltas), box))
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_distance_and_distances_to_all(rng):
    box = Box(10.0, 10.0)
    p = jnp.array([9.5, 0.5])
    others = jnp.array([[0.5, 9.5], [9.0, 0.0], [5.0, 5.0]])
    d = np.asarray(distances_to_all(p, others, box))
    # across-corner distance: dx = -1 -> wraps, dy = -9 -> 1
    np.testing.assert_allclose(d[0], np.sqrt(1.0 + 1.0), atol=1e-5)
    np.testing.assert_allclose(d[1], np.sqrt(0.25 + 0.25), atol=1e-5)
    d_single = float(distance(p, others[0], box))
    np.testing.assert_allclose(d_single, d[0], atol=1e-6)


def test_pair_distance_matrix_symmetry(rng):
    box = Box(8.0, 6.0)
    pos = jnp.asarray(rng.uniform(0, 6, size=(5, 2)))
    m = np.asarray(pair_distance_matrix(pos, box))
    np.testing.assert_allclose(m, m.T, atol=1e-6)
    np.testing.assert_allclose(np.diag(m), 0.0, atol=1e-6)
    tri = np.asarray(upper_triangle_distances(pos, box))
    iu, ju = np.triu_indices(5, k=1)
    np.testing.assert_allclose(tri, m[iu, ju], atol=1e-6)


def test_min_image_centered():
    # SimpleLJ.py:20 frame: period 2*bound around 0
    d = jnp.array([6.0, -7.0, 2.0])
    got = np.asarray(min_image_centered(d, 5.0))
    np.testing.assert_allclose(got, [-4.0, 3.0, 2.0], atol=1e-6)
