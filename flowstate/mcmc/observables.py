"""Equilibration checks and ensemble-level observable helpers.

Reference equivalents:
* ``check_equilibration`` — steady pressure/density windows
  (``MCMC/monte_carlo.py:449-475``).
* acceptance bookkeeping — ``attempts/accepts`` ratios
  (``MCMC/main.py:268-274``).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from flowstate.mcmc.state import ChainState


def check_equilibration(pressure_history: np.ndarray,
                        density_history: np.ndarray,
                        tolerance: float = 0.05,
                        window: int = 500) -> bool:
    """Relative-std steadiness check; reference monte_carlo.py:449-475."""
    if len(pressure_history) < window:
        return False
    p = np.asarray(pressure_history[-window:])
    d = np.asarray(density_history[-window:])
    conds = []
    for arr in (p, d):
        mean = arr.mean()
        conds.append(bool(arr.std() / mean < tolerance) if mean != 0 else False)
    return all(conds)


def acceptance_fraction(state: ChainState) -> jnp.ndarray:
    """Per-chain acceptance ratio over the whole run."""
    att = jnp.maximum(state.attempts, 1)
    return state.accepts / att.astype(jnp.float32)


def ensemble_acceptance(state: ChainState) -> Tuple[int, int]:
    """(total accepted, total attempted) across the chain batch."""
    return int(jnp.sum(state.accepts)), int(jnp.sum(state.attempts))
