"""Radial distribution function g(r) over configuration stacks.

Equivalent of the reference ``calculate_pair_correlation``
(``hybrid_NF_MCMC/utils.py:530-574``): per-frame min-image pair distances,
annulus-normalized histogram, averaged over frames.  The reference loops
frames in Python with a tqdm bar; here the whole stack is one vectorized
histogram (and can run jitted on device for huge stacks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def calculate_pair_correlation(samples: np.ndarray, n_particles: int,
                               bound: float, dr: Optional[float] = None,
                               normalization: str = "reference"
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """RDF of centered-frame samples.

    Args:
      samples: (T, N, 2) configurations centered at 0 (coords in
        [-bound, bound]).
      bound: half box length.
      dr: bin width (default bound / 50, as reference utils.py:543-544).
      normalization: "reference" reproduces the reference's scale exactly
        (full (i != j) distance matrix over norm n(n-1)/2 — which makes an
        ideal gas read g = 2/n, a constant-scale quirk present in BOTH
        reference variants, utils.py:556-567 and NF/utils.py:363-378);
        "physical" rescales by n/2 so an ideal gas reads g = 1.

    Returns:
      (r values, g(r)) averaged over frames.
    """
    if normalization not in ("reference", "physical"):
        raise ValueError(normalization)
    if dr is None:
        dr = bound / 50.0
    arr = np.asarray(samples, dtype=np.float64)
    t, n, _ = arr.shape
    L = 2.0 * bound

    diff = arr[:, :, None, :] - arr[:, None, :, :]
    diff -= L * np.round(diff / L)
    dist = np.sqrt(np.sum(diff * diff, axis=-1))  # (T, N, N)
    iu, ju = np.triu_indices(n, k=1)
    pair_d = dist[:, iu, ju]  # unique pairs; reference flattens the full
    # matrix (both (i,j) and (j,i)) — compensate with a factor 2 below.

    edges = np.arange(0.0, bound + dr, dr)
    counts = np.stack([np.histogram(pair_d[f], edges)[0] for f in range(t)])
    counts = counts * 2.0  # full-matrix double counting (utils.py:556-559)

    norm = n * (n - 1) / 2.0
    rho = n / (4.0 * bound * bound)
    i_vals = np.arange(0.0, bound, dr)
    area = np.pi * ((i_vals + dr) ** 2 - i_vals**2)
    ncols = len(i_vals)
    g_r = (counts[:, :ncols] / (norm * rho * area)).mean(axis=0)
    if normalization == "physical":
        g_r = g_r * (n / 2.0)
    return i_vals, g_r
