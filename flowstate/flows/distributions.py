"""Base distributions for the flow library (pure functional, pytree params).

Equivalents of the reference's bases:

* ``UniformParticle``  — the load-bearing base of every hybrid run
  (``NF/normflows/Energy/Uniform.py:4-74``): uniform on
  ``[-bound, bound]^(N*d)``, constant log-prob in bounds, ``-inf`` outside.
* ``DiagGaussian``     — ``NF/normflows/distributions/base.py:52-155``.
* ``UniformBase``      — ``NF/normflows/distributions/base.py:158-196``.
* ``UniformGaussian``  — ``NF/normflows/distributions/base.py:198-276``
  (with the fork's quirk that ``sample`` draws uniform noise for **both**
  index groups and ``log_prob`` returns only the uniform part — replicated
  behind ``fork_semantics=True``, fixed otherwise).

These distributions are stateless dataclass-style configs; trainable bases
(e.g. DiagGaussian's loc/scale) expose ``init_params`` and take params as the
first argument.  The parameter-free ones accept ``params=None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class UniformParticle:
    """Uniform base on the torus [-bound, bound]^(n_particles * n_dim).

    Reference ``Energy/Uniform.py:4-74``.  ``sample`` returns bare samples
    (no log-prob) exactly like the fork; ``log_prob`` is the constant
    ``-D log(2 bound)`` in bounds and ``-inf`` outside.
    """

    n_particles: int
    n_dim: int
    bound: float

    @property
    def dim(self) -> int:
        return self.n_particles * self.n_dim

    def sample(self, key: jax.Array, num_samples: int) -> jnp.ndarray:
        return jax.random.uniform(
            key, (num_samples, self.dim), minval=-self.bound,
            maxval=self.bound, dtype=jnp.float32)

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        in_bounds = jnp.all((z >= -self.bound) & (z <= self.bound), axis=-1)
        const = -self.dim * jnp.log(2.0 * self.bound)
        return jnp.where(in_bounds, const, -jnp.inf).astype(z.dtype)


@dataclasses.dataclass(frozen=True)
class UniformBase:
    """Uniform on a general box [low, high]^shape; reference ``base.py:158-196``."""

    dim: int
    low: float = -1.0
    high: float = 1.0

    def sample(self, key: jax.Array, num_samples: int) -> jnp.ndarray:
        return jax.random.uniform(key, (num_samples, self.dim),
                                  minval=self.low, maxval=self.high)

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        in_bounds = jnp.all((z >= self.low) & (z <= self.high), axis=-1)
        const = -self.dim * jnp.log(self.high - self.low)
        return jnp.where(in_bounds, const, -jnp.inf).astype(z.dtype)


@dataclasses.dataclass(frozen=True)
class DiagGaussian:
    """Diagonal Gaussian with trainable loc / log-scale.

    Reference ``distributions/base.py:52-155``.
    """

    dim: int
    trainable: bool = True

    def init_params(self):
        return {"loc": jnp.zeros((self.dim,)),
                "log_scale": jnp.zeros((self.dim,))}

    def sample(self, key: jax.Array, num_samples: int,
               params=None) -> jnp.ndarray:
        params = params or self.init_params()
        eps = jax.random.normal(key, (num_samples, self.dim))
        return params["loc"] + jnp.exp(params["log_scale"]) * eps

    def log_prob(self, z: jnp.ndarray, params=None) -> jnp.ndarray:
        params = params or self.init_params()
        log_scale = params["log_scale"]
        norm = -0.5 * self.dim * jnp.log(2.0 * jnp.pi)
        z_std = (z - params["loc"]) * jnp.exp(-log_scale)
        return norm - jnp.sum(log_scale) - 0.5 * jnp.sum(z_std**2, axis=-1)


@dataclasses.dataclass(frozen=True)
class UniformGaussian:
    """Mixed base: uniform on some indices, Gaussian on the rest.

    Reference ``distributions/base.py:198-276``.  The fork modified it so
    ``sample`` draws **uniform** noise for both groups (``base.py:245-263``)
    and ``log_prob`` returns only the uniform part (``base.py:265-275``);
    set ``fork_semantics=False`` for the mathematically consistent version.
    """

    dim: int
    ind_uniform: Tuple[int, ...]
    scale: Optional[Tuple[float, ...]] = None
    fork_semantics: bool = True

    def _split(self):
        ind_u = np.asarray(self.ind_uniform, dtype=np.int64)
        ind_g = np.asarray([i for i in range(self.dim)
                            if i not in set(self.ind_uniform)], dtype=np.int64)
        return ind_u, ind_g

    def _scales(self, dtype):
        if self.scale is None:
            return jnp.ones((self.dim,), dtype=dtype)
        return jnp.asarray(self.scale, dtype=dtype)

    def sample(self, key: jax.Array, num_samples: int) -> jnp.ndarray:
        ind_u, ind_g = self._split()
        scales = self._scales(jnp.float32)
        ku, kg = jax.random.split(key)
        out = jnp.zeros((num_samples, self.dim))
        u = jax.random.uniform(key=ku, shape=(num_samples, len(ind_u)),
                               minval=-0.5, maxval=0.5)
        out = out.at[:, ind_u].set(u * scales[ind_u])
        if len(ind_g):
            if self.fork_semantics:
                g = jax.random.uniform(key=kg, shape=(num_samples, len(ind_g)),
                                       minval=-0.5, maxval=0.5)
            else:
                g = jax.random.normal(kg, (num_samples, len(ind_g)))
            out = out.at[:, ind_g].set(g * scales[ind_g])
        return out

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        ind_u, ind_g = self._split()
        scales = self._scales(z.dtype)
        log_u = -jnp.sum(jnp.log(scales[ind_u]))
        log_u = jnp.broadcast_to(log_u, z.shape[:-1])
        if self.fork_semantics or len(ind_g) == 0:
            return log_u
        zg = z[..., ind_g] / scales[ind_g]
        log_g = (-0.5 * len(ind_g) * jnp.log(2 * jnp.pi)
                 - jnp.sum(jnp.log(scales[ind_g]))
                 - 0.5 * jnp.sum(zg**2, axis=-1))
        return log_u + log_g


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Trainable mixture of diagonal Gaussians; reference ``base.py:578-664``."""

    n_modes: int
    dim: int

    def init_params(self, key: jax.Array, loc_scale: float = 1.0):
        kl, = jax.random.split(key, 1)
        return {
            "loc": loc_scale * jax.random.normal(kl, (self.n_modes, self.dim)),
            "log_scale": jnp.zeros((self.n_modes, self.dim)),
            "weight_logits": jnp.zeros((self.n_modes,)),
        }

    def sample(self, key: jax.Array, num_samples: int, params=None) -> jnp.ndarray:
        kc, kn = jax.random.split(key)
        mode = jax.random.categorical(kc, params["weight_logits"],
                                      shape=(num_samples,))
        eps = jax.random.normal(kn, (num_samples, self.dim))
        loc = params["loc"][mode]
        scale = jnp.exp(params["log_scale"])[mode]
        return loc + scale * eps

    def log_prob(self, z: jnp.ndarray, params=None) -> jnp.ndarray:
        log_w = jax.nn.log_softmax(params["weight_logits"])
        z_ = (z[..., None, :] - params["loc"]) * jnp.exp(-params["log_scale"])
        comp = (-0.5 * self.dim * jnp.log(2 * jnp.pi)
                - jnp.sum(params["log_scale"], axis=-1)
                - 0.5 * jnp.sum(z_**2, axis=-1))
        return jax.scipy.special.logsumexp(log_w + comp, axis=-1)


@dataclasses.dataclass(frozen=True)
class ClassCondDiagGaussian:
    """Class-conditional diagonal Gaussian; ref ``base.py:278-351``.

    y is one-hot (B, num_classes); per-class loc/log_scale are trainable.
    """

    dim: int
    num_classes: int

    def init_params(self):
        return {"loc": jnp.zeros((self.num_classes, self.dim)),
                "log_scale": jnp.zeros((self.num_classes, self.dim))}

    def sample(self, key: jax.Array, num_samples: int, y,
               params=None, temperature: Optional[float] = None):
        params = params or self.init_params()
        loc = y @ params["loc"]
        log_scale = y @ params["log_scale"]
        if temperature is not None:
            log_scale = log_scale + jnp.log(temperature)
        eps = jax.random.normal(key, (num_samples, self.dim))
        return loc + jnp.exp(log_scale) * eps

    def log_prob(self, z, y, params=None,
                 temperature: Optional[float] = None):
        params = params or self.init_params()
        loc = y @ params["loc"]
        log_scale = y @ params["log_scale"]
        if temperature is not None:
            log_scale = log_scale + jnp.log(temperature)
        return (-0.5 * self.dim * jnp.log(2 * jnp.pi)
                - jnp.sum(log_scale
                          + 0.5 * ((z - loc) / jnp.exp(log_scale)) ** 2,
                          axis=-1))


@dataclasses.dataclass(frozen=True)
class GlowBase:
    """Glow base: per-channel Gaussian on (C, H, W); ref ``base.py:352-477``.

    loc/log_scale are per channel, scaled by ``logscale_factor``.
    """

    shape: Tuple[int, ...]   # (C, H, W)
    logscale_factor: float = 3.0

    def init_params(self):
        c = self.shape[0]
        return {"loc": jnp.zeros((c,)), "log_scale_raw": jnp.zeros((c,))}

    def _moments(self, params):
        loc = params["loc"] * self.logscale_factor
        log_scale = params["log_scale_raw"] * self.logscale_factor
        bshape = (1, self.shape[0]) + (1,) * (len(self.shape) - 1)
        return loc.reshape(bshape), log_scale.reshape(bshape)

    def sample(self, key: jax.Array, num_samples: int, params=None,
               temperature: Optional[float] = None):
        params = params or self.init_params()
        loc, log_scale = self._moments(params)
        if temperature is not None:
            log_scale = log_scale + jnp.log(temperature)
        eps = jax.random.normal(key, (num_samples, *self.shape))
        return loc + jnp.exp(log_scale) * eps

    def log_prob(self, z, params=None,
                 temperature: Optional[float] = None):
        params = params or self.init_params()
        loc, log_scale = self._moments(params)
        if temperature is not None:
            log_scale = log_scale + jnp.log(temperature)
        d = float(np.prod(self.shape))
        num_pix = float(np.prod(self.shape[1:]))
        axes = tuple(range(1, len(self.shape) + 1))
        return (-0.5 * d * jnp.log(2 * jnp.pi)
                - num_pix * jnp.sum(log_scale)
                - 0.5 * jnp.sum(((z - loc) / jnp.exp(log_scale)) ** 2,
                                axis=axes))


@dataclasses.dataclass(frozen=True)
class AffineGaussian:
    """Diagonal Gaussian with trainable affine scaling on a data shape;
    ref ``base.py:479-576``: z = e^s * eps, log_p adjusted by -sum(s)."""

    dim: int

    def init_params(self):
        return {"s": jnp.zeros((self.dim,))}

    def sample(self, key: jax.Array, num_samples: int, params=None):
        params = params or self.init_params()
        eps = jax.random.normal(key, (num_samples, self.dim))
        return jnp.exp(params["s"]) * eps

    def log_prob(self, z, params=None):
        params = params or self.init_params()
        eps = z * jnp.exp(-params["s"])
        return (-0.5 * self.dim * jnp.log(2 * jnp.pi)
                - jnp.sum(params["s"])
                - 0.5 * jnp.sum(eps**2, axis=-1))


@dataclasses.dataclass(frozen=True)
class GaussianPCA:
    """Low-rank Gaussian z = W eps + mu; ref ``base.py:667-724``."""

    dim: int
    latent_dim: int
    sigma: float = 0.1

    def init_params(self, key: jax.Array):
        return {"W": 0.1 * jax.random.normal(key,
                                             (self.latent_dim, self.dim)),
                "loc": jnp.zeros((self.dim,))}

    def sample(self, key: jax.Array, num_samples: int, params):
        eps = jax.random.normal(key, (num_samples, self.latent_dim))
        return params["loc"] + eps @ params["W"]

    def log_prob(self, z, params):
        w = params["W"]
        cov = w.T @ w + self.sigma**2 * jnp.eye(self.dim)
        diff = z - params["loc"]
        sol = jnp.linalg.solve(cov, diff.T).T
        _, logdet = jnp.linalg.slogdet(cov)
        return (-0.5 * self.dim * jnp.log(2 * jnp.pi) - 0.5 * logdet
                - 0.5 * jnp.sum(diff * sol, axis=-1))
