"""Planar and radial flows (the classic Rezende & Mohamed 2015 layers).

Equivalents of ``NF/normflows/flows/planar.py`` and
``flows/radial.py``:

* ``Planar``  — f(z) = z + u h(w.z + b) with the w.u > -1 constraint
  reparameterization (``planar.py:9-81``); algebraic inverse only for
  leaky_relu, as the reference.
* ``Radial``  — f(z) = z + beta h(alpha, r)(z - z0) (``radial.py:8-46``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Planar:
    dim: int
    act: str = "tanh"
    negative_slope: float = 0.2

    def init_params(self, key: jax.Array):
        ku, kw = jax.random.split(key)
        lim_w = np.sqrt(2.0 / self.dim)
        lim_u = np.sqrt(2.0)
        return {
            "u": jax.random.uniform(ku, (self.dim,), minval=-lim_u,
                                    maxval=lim_u),
            "w": jax.random.uniform(kw, (self.dim,), minval=-lim_w,
                                    maxval=lim_w),
            "b": jnp.zeros(()),
        }

    def _constrained_u(self, params):
        """Enforce w.u > -1 (planar.py:55-57)."""
        u, w = params["u"], params["w"]
        inner = jnp.sum(w * u)
        return u + (jax.nn.softplus(inner) - 1.0 - inner) * w / jnp.sum(w**2)

    def _h(self, x):
        if self.act == "tanh":
            return jnp.tanh(x)
        elif self.act == "leaky_relu":
            return jnp.where(x < 0, self.negative_slope * x, x)
        raise NotImplementedError("Nonlinearity is not implemented.")

    def _h_prime(self, x):
        if self.act == "tanh":
            return 1.0 / jnp.cosh(x) ** 2
        return jnp.where(x < 0, self.negative_slope, 1.0)

    def forward(self, params, z):
        w, b = params["w"], params["b"]
        u = self._constrained_u(params)
        lin = jnp.sum(w * z, axis=-1, keepdims=True) + b
        z_ = z + u * self._h(lin)
        log_det = jnp.log(jnp.abs(
            1.0 + jnp.sum(w * u) * self._h_prime(lin[..., 0])))
        return z_, log_det

    def inverse(self, params, z):
        if self.act != "leaky_relu":
            raise NotImplementedError("This flow has no algebraic inverse.")
        w, b = params["w"], params["b"]
        u = self._constrained_u(params)
        lin = jnp.sum(w * z, axis=-1) + b
        a = jnp.where(lin < 0, self.negative_slope, 1.0)  # planar.py:70-72
        u_eff = a[:, None] * u
        inner = jnp.sum(w * u_eff, axis=-1)
        z_ = z - u_eff * (lin / (1.0 + inner))[:, None]
        log_det = -jnp.log(jnp.abs(1.0 + inner))
        return z_, log_det


@dataclasses.dataclass(frozen=True)
class Radial:
    dim: int

    def init_params(self, key: jax.Array):
        kb, ka, kz = jax.random.split(key, 3)
        lim = 1.0 / self.dim
        return {
            "beta": jax.random.uniform(kb, (), minval=-lim - 1.0,
                                       maxval=lim - 1.0),
            "alpha": jax.random.uniform(ka, (), minval=-lim, maxval=lim),
            "z_0": jax.random.normal(kz, (self.dim,)),
        }

    def forward(self, params, z):
        beta = jax.nn.softplus(params["beta"]) - jnp.abs(params["alpha"])
        dz = z - params["z_0"]
        r = jnp.linalg.norm(dz, axis=-1, keepdims=True)
        h = beta / (jnp.abs(params["alpha"]) + r)
        h_prime = -beta * r / (jnp.abs(params["alpha"]) + r) ** 2
        z_ = z + h * dz
        log_det = ((self.dim - 1) * jnp.log(1.0 + h[..., 0])
                   + jnp.log(1.0 + h[..., 0] + h_prime[..., 0]))
        return z_, log_det

    def inverse(self, params, z):
        raise NotImplementedError("Radial flow has no algebraic inverse.")
