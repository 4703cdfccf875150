"""Stochastic normalizing-flow layers (MCMC transitions inside the flow).

Equivalents of ``NF/normflows/flows/stochastic.py``:

* ``MetropolisHastings``   — MH transitions toward a target density
  (``stochastic.py:6-50``); the log-det accumulates log p(z) - log p(z')
  per accepted step (the SNF importance-weight bookkeeping).
* ``HamiltonianMonteCarlo`` — leapfrog HMC transition with trainable
  step size / mass (``stochastic.py:52-109``); the target gradient uses
  ``jax.grad`` instead of torch autograd.

Being stochastic, these layers take an explicit PRNG key:
``forward(params, z, key)``.  ``inverse`` is the same transition, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DiagGaussianProposal:
    """Diagonal-Gaussian random-walk proposal; ref ``distributions/mh_proposal.py:47-83``.

    Returns (z', log q(z|z') - log q(z'|z)) which is 0 for a symmetric
    proposal.
    """

    dim: int
    scale: float = 0.1

    def init_params(self, key: jax.Array):
        return {"log_scale": jnp.full((self.dim,), jnp.log(self.scale))}

    def propose(self, params, z, key):
        eps = jax.random.normal(key, z.shape)
        z_ = z + eps * jnp.exp(params["log_scale"])
        return z_, jnp.zeros(z.shape[0], dtype=z.dtype)


@dataclasses.dataclass(frozen=True)
class MetropolisHastings:
    """MH transition layer; ref ``stochastic.py:6-50``."""

    target: Any          # exposes log_prob(z)
    proposal: Any        # exposes init_params/propose(params, z, key)
    steps: int

    def init_params(self, key: jax.Array):
        return {"proposal": self.proposal.init_params(key)}

    def forward(self, params, z, key):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        log_p = self.target.log_prob(z)

        def step(carry, k):
            z, log_det, log_p = carry
            k_prop, k_acc = jax.random.split(k)
            z_, log_p_diff = self.proposal.propose(params["proposal"], z,
                                                   k_prop)
            log_p_ = self.target.log_prob(z_)
            w = jax.random.uniform(k_acc, (z.shape[0],), dtype=z.dtype)
            w_accept = jnp.minimum(jnp.exp(log_p_ - log_p + log_p_diff), 1.0)
            accept = w <= w_accept
            z = jnp.where(accept[:, None], z_, z)
            log_det = jnp.where(accept, log_det + log_p - log_p_, log_det)
            log_p = jnp.where(accept, log_p_, log_p)
            return (z, log_det, log_p), None

        keys = jax.random.split(key, self.steps)
        (z, log_det, _), _ = jax.lax.scan(step, (z, log_det, log_p), keys)
        return z, log_det

    def inverse(self, params, z, key):
        return self.forward(params, z, key)


@dataclasses.dataclass(frozen=True)
class HamiltonianMonteCarlo:
    """HMC transition layer; ref ``stochastic.py:52-109``."""

    target: Any
    steps: int
    dim: int
    max_abs_grad: Optional[float] = None

    def init_params(self, key: jax.Array):
        return {"log_step_size": jnp.full((self.dim,), jnp.log(0.1)),
                "log_mass": jnp.zeros((self.dim,))}

    def _grad_log_p(self, z):
        grad = jax.vmap(jax.grad(lambda x: self.target.log_prob(x[None])[0]))(z)
        if self.max_abs_grad is not None:
            grad = jnp.clip(grad, -self.max_abs_grad, self.max_abs_grad)
        return grad

    def forward(self, params, z, key):
        k_mom, k_acc = jax.random.split(key)
        mass = jnp.exp(params["log_mass"])
        step_size = jnp.exp(params["log_step_size"])
        p = jax.random.normal(k_mom, z.shape) * jnp.exp(
            0.5 * params["log_mass"])

        def leapfrog(carry, _):
            z_new, p_new = carry
            p_half = p_new + (step_size / 2.0) * self._grad_log_p(z_new)
            z_new = z_new + step_size * (p_half / mass)
            p_new = p_half + (step_size / 2.0) * self._grad_log_p(z_new)
            return (z_new, p_new), None

        (z_new, p_new), _ = jax.lax.scan(leapfrog, (z, p), None,
                                         length=self.steps)

        log_accept = (self.target.log_prob(z_new) - self.target.log_prob(z)
                      - 0.5 * jnp.sum(p_new**2 / mass, axis=1)
                      + 0.5 * jnp.sum(p**2 / mass, axis=1))
        u = jax.random.uniform(k_acc, (z.shape[0],), dtype=z.dtype)
        accept = u < jnp.exp(log_accept)
        z_out = jnp.where(accept[:, None], z_new, z)
        log_det = self.target.log_prob(z) - self.target.log_prob(z_out)
        return z_out, log_det

    def inverse(self, params, z, key):
        return self.forward(params, z, key)
