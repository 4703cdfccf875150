"""VAE-style encoders/decoders and the flow-VAE model.

Equivalents of ``NF/normflows/distributions/encoder.py`` /
``decoder.py`` and the ``NormalizingFlowVAE`` model (``core.py:673-717``):

* ``Dirac``                — ``encoder.py:39-52``
* ``UniformEncoder``       — ``encoder.py:53-73``
* ``ConstDiagGaussian``    — ``encoder.py:74-129``
* ``NNDiagGaussian``       — ``encoder.py:130-188``
* ``NNDiagGaussianDecoder``— ``decoder.py:34-72``
* ``NNBernoulliDecoder``   — ``decoder.py:73-102``
* ``NormalizingFlowVAE``   — ``core.py:673-717``

Encoders return (z, log q(z|x)) for num_samples per input; decoders return
log p(x|z).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Dirac:
    """z = x deterministic encoder; ref ``encoder.py:39-52``."""

    def sample(self, params, key, x, num_samples=1):
        z = jnp.repeat(x[:, None, :], num_samples, axis=1)
        return z, jnp.zeros(z.shape[:2])

    def log_prob(self, params, z, x):
        return jnp.zeros(z.shape[:-1])


@dataclasses.dataclass(frozen=True)
class UniformEncoder:
    """Uniform encoder on [zmin, zmax]; ref ``encoder.py:53-73``."""

    zmin: float = 0.0
    zmax: float = 1.0

    def sample(self, params, key, x, num_samples=1):
        b, d = x.shape
        z = jax.random.uniform(key, (b, num_samples, d), minval=self.zmin,
                               maxval=self.zmax)
        log_q = -jnp.log(self.zmax - self.zmin) * d
        return z, jnp.full((b, num_samples), log_q)

    def log_prob(self, params, z, x):
        d = z.shape[-1]
        return jnp.full(z.shape[:-1], -jnp.log(self.zmax - self.zmin) * d)


@dataclasses.dataclass(frozen=True)
class ConstDiagGaussian:
    """q(z|x) = N(loc, scale) independent of x; ref ``encoder.py:74-129``."""

    dim: int

    def init_params(self, key: jax.Array):
        return {"loc": jnp.zeros((self.dim,)),
                "log_scale": jnp.zeros((self.dim,))}

    def sample(self, params, key, x, num_samples=1):
        b = x.shape[0]
        eps = jax.random.normal(key, (b, num_samples, self.dim))
        scale = jnp.exp(params["log_scale"])
        z = params["loc"] + scale * eps
        log_q = (-0.5 * self.dim * jnp.log(2 * jnp.pi)
                 - jnp.sum(params["log_scale"] + 0.5 * eps**2, axis=-1))
        return z, log_q

    def log_prob(self, params, z, x):
        scale = jnp.exp(params["log_scale"])
        eps = (z - params["loc"]) / scale
        return (-0.5 * self.dim * jnp.log(2 * jnp.pi)
                - jnp.sum(params["log_scale"] + 0.5 * eps**2, axis=-1))


@dataclasses.dataclass(frozen=True)
class NNDiagGaussian:
    """Neural amortized diagonal Gaussian q(z|x); ref ``encoder.py:130-188``.

    ``net``: net config mapping x -> [mean (d), log_var-ish raw (d)].
    """

    net: Any
    latent_dim: int

    def init_params(self, key: jax.Array):
        return {"net": self.net.init_params(key)}

    def _moments(self, params, x):
        raw = self.net.apply(params["net"], x)
        d = self.latent_dim
        mean = raw[..., :d]
        std = jnp.exp(0.5 * raw[..., d: 2 * d])
        return mean, std

    def sample(self, params, key, x, num_samples=1):
        mean, std = self._moments(params, x)
        b = x.shape[0]
        eps = jax.random.normal(key, (b, num_samples, self.latent_dim))
        z = mean[:, None, :] + std[:, None, :] * eps
        log_q = (-0.5 * self.latent_dim * jnp.log(2 * jnp.pi)
                 - jnp.sum(jnp.log(std)[:, None, :] + 0.5 * eps**2, axis=-1))
        return z, log_q

    def log_prob(self, params, z, x):
        mean, std = self._moments(params, x)
        eps = (z - mean[:, None, :]) / std[:, None, :]
        return (-0.5 * self.latent_dim * jnp.log(2 * jnp.pi)
                - jnp.sum(jnp.log(std)[:, None, :] + 0.5 * eps**2, axis=-1))


@dataclasses.dataclass(frozen=True)
class NNDiagGaussianDecoder:
    """p(x|z) = N(mean(z), std(z)); ref ``decoder.py:34-72``."""

    net: Any
    data_dim: int

    def init_params(self, key: jax.Array):
        return {"net": self.net.init_params(key)}

    def log_prob(self, params, x, z):
        raw = self.net.apply(params["net"], z)
        d = self.data_dim
        mean = raw[..., :d]
        log_var = raw[..., d: 2 * d]
        return (-0.5 * d * jnp.log(2 * jnp.pi)
                - jnp.sum(0.5 * log_var
                          + 0.5 * (x - mean) ** 2 / jnp.exp(log_var),
                          axis=-1))


@dataclasses.dataclass(frozen=True)
class NNBernoulliDecoder:
    """p(x|z) = Bernoulli(sigmoid(net(z))); ref ``decoder.py:73-102``."""

    net: Any

    def init_params(self, key: jax.Array):
        return {"net": self.net.init_params(key)}

    def log_prob(self, params, x, z):
        logits = self.net.apply(params["net"], z)
        return jnp.sum(x * jax.nn.log_sigmoid(logits)
                       + (1 - x) * jax.nn.log_sigmoid(-logits), axis=-1)


@dataclasses.dataclass(frozen=True)
class NormalizingFlowVAE:
    """VAE with flow-augmented posterior; ref ``core.py:673-717``.

    forward(x): encode, push z through flows, score under prior + decoder.
    Returns (z, log_q, log_p) as the reference.
    """

    prior: Any       # log_prob(z)
    encoder: Any
    flows: Tuple[Any, ...]
    decoder: Any

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.flows) + 2)
        return {
            "encoder": (self.encoder.init_params(keys[0])
                        if hasattr(self.encoder, "init_params") else {}),
            "flows": tuple(f.init_params(k)
                           for f, k in zip(self.flows, keys[1:-1])),
            "decoder": (self.decoder.init_params(keys[-1])
                        if hasattr(self.decoder, "init_params") else {}),
        }

    def forward(self, params, key, x, num_samples: int = 1):
        z, log_q = self.encoder.sample(params["encoder"], key, x,
                                       num_samples)
        b, m, d = z.shape
        z = z.reshape(b * m, d)
        log_q = log_q.reshape(b * m)
        for flow, p in zip(self.flows, params["flows"]):
            z, log_det = flow.forward(p, z)
            log_q = log_q - log_det
        log_p = self.prior.log_prob(z)
        if self.decoder is not None:
            x_rep = jnp.repeat(x, m, axis=0)
            log_p = log_p + self.decoder.log_prob(params["decoder"], x_rep, z)
        return (z.reshape(b, m, d), log_q.reshape(b, m),
                log_p.reshape(b, m))
