"""Sampling utilities: Hamiltonian Annealed Importance Sampling.

Equivalent of ``NF/normflows/sampling/hais.py:8-49``: an
annealing schedule of geometric interpolations between prior and target,
each bridged by an HMC transition, producing weighted samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.stochastic import HamiltonianMonteCarlo
from flowstate.flows.toy_targets import LinearInterpolation


@dataclasses.dataclass(frozen=True)
class HAIS:
    """Hamiltonian AIS; ref ``sampling/hais.py:8-49``.

    betas: annealing schedule 1 = beta_0 > ... > beta_n = 0; the j-th
    intermediate density is target^beta_j * prior^(1-beta_j).
    ``prior`` must expose ``sample(key, n)`` and ``log_prob(z)``.
    """

    betas: Tuple[float, ...]
    prior: Any
    target: Any
    num_leapfrog: int
    dim: int
    step_size: float = 0.1

    def _layers(self):
        n = len(self.betas) - 1
        layers = []
        for i in range(n - 1, 0, -1):
            inter = LinearInterpolation(self.target, self.prior,
                                        float(self.betas[i]))
            layers.append(HamiltonianMonteCarlo(
                target=inter, steps=self.num_leapfrog, dim=self.dim))
        return layers

    def init_params(self, key: jax.Array):
        layers = self._layers()
        keys = jax.random.split(key, max(1, len(layers)))
        params = []
        for layer, k in zip(layers, keys):
            p = layer.init_params(k)
            p["log_step_size"] = jnp.full((self.dim,),
                                          jnp.log(self.step_size))
            params.append(p)
        return params

    def sample(self, params, key: jax.Array, num_samples: int):
        """Draw weighted samples: returns (samples, log_weights)."""
        k_init, k_hmc = jax.random.split(key)
        samples = self.prior.sample(k_init, num_samples)
        log_weights = -self.prior.log_prob(samples)
        layers = self._layers()
        keys = jax.random.split(k_hmc, max(1, len(layers)))
        for layer, p, k in zip(layers, params, keys):
            samples, lw = layer.forward(p, samples, k)
            log_weights = log_weights + lw
        log_weights = log_weights + self.target.log_prob(samples)
        return samples, log_weights
