"""2D toy targets and energy-landscape priors (for flow testing/demos).

Equivalents of ``NF/normflows/distributions/target.py`` and
``distributions/prior.py``:

* ``TwoMoons``                — ``target.py:99-129``
* ``CircularGaussianMixture`` — ``target.py:132-173``
* ``RingMixture``             — ``target.py:176-195``
* ``ConditionalDiagGaussian`` — ``target.py:198-225``
* ``TwoIndependent``          — ``target.py:76-96``
* ``TwoModes``                — ``prior.py:107-149``
* ``Sinusoidal`` (+ gap/split variants) — ``prior.py:152-298``
* ``Smiley``                  — ``prior.py:299-327``
* ``LinearInterpolation``     — ``distributions/linear_interpolation.py``

All expose ``log_prob(z)`` on (B, 2) batches; samplable ones expose
``sample(key, n)``.  Rejection-sampling based ``Target.sample`` of the
reference (``target.py:29-73``) is provided generically.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _take_accepted(z: jnp.ndarray, accept: jnp.ndarray,
                   num_samples: int) -> jnp.ndarray:
    """First ``num_samples`` accepted proposals, cycling through the
    accepted set on shortfall (never returning rejected proposals; if
    nothing is accepted the single clamped index repeats proposal 0 —
    callers oversample enough that this is a measure-zero event for any
    non-degenerate target)."""
    order = jnp.argsort(~accept)  # accepted (False<True) first
    n_acc = jnp.maximum(jnp.sum(accept), 1)
    pick = jnp.mod(jnp.arange(num_samples), n_acc)
    return z[order[pick]]


def rejection_sample(target, key: jax.Array, num_samples: int,
                     prop_scale: float = 6.0, prop_shift: float = -3.0,
                     max_log_prob: float = 0.0,
                     oversample: int = 16) -> jnp.ndarray:
    """Uniform-proposal rejection sampling; reference ``target.py:29-73``.

    Draws ``oversample * num_samples`` proposals in one device batch and
    keeps the first ``num_samples`` accepted (padding by cycling through
    the accepted points if short — statistically safe for the toy targets;
    raise ``oversample`` for low-acceptance targets to avoid duplicates).
    """
    k_prop, k_acc = jax.random.split(key)
    n_prop = oversample * num_samples
    z = prop_shift + prop_scale * jax.random.uniform(
        k_prop, (n_prop, target.n_dims))
    prob = jax.random.uniform(k_acc, (n_prop,))
    accept = jnp.exp(target.log_prob(z) - max_log_prob) > prob
    return _take_accepted(z, accept, num_samples)


@dataclasses.dataclass(frozen=True)
class TwoMoons:
    """Bimodal crescent target; ref ``target.py:99-129``."""

    n_dims: int = 2
    max_log_prob: float = 0.0

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        a = jnp.abs(z[:, 0])
        return (-0.5 * ((jnp.linalg.norm(z, axis=1) - 2) / 0.2) ** 2
                - 0.5 * ((a - 2) / 0.3) ** 2
                + jnp.log1p(jnp.exp(-4 * a / 0.09)))

    def sample(self, key: jax.Array, num_samples: int) -> jnp.ndarray:
        return rejection_sample(self, key, num_samples)


@dataclasses.dataclass(frozen=True)
class CircularGaussianMixture:
    """Gaussians on a circle; ref ``target.py:132-173``."""

    n_modes: int = 8
    n_dims: int = 2

    @property
    def scale(self) -> float:
        return float(2 / 3 * np.sin(np.pi / self.n_modes))

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        i = jnp.arange(self.n_modes)
        locs = jnp.stack([2 * jnp.sin(2 * jnp.pi / self.n_modes * i),
                          2 * jnp.cos(2 * jnp.pi / self.n_modes * i)], axis=1)
        d = jnp.sum((z[:, None, :] - locs) ** 2, axis=-1) / (2 * self.scale**2)
        return (-jnp.log(2 * jnp.pi * self.scale**2 * self.n_modes)
                + jax.scipy.special.logsumexp(-d, axis=1))

    def sample(self, key: jax.Array, num_samples: int) -> jnp.ndarray:
        k_eps, k_phi = jax.random.split(key)
        eps = jax.random.normal(k_eps, (num_samples, 2))
        phi = 2 * jnp.pi / self.n_modes * jax.random.randint(
            k_phi, (num_samples,), 0, self.n_modes)
        loc = jnp.stack([2 * jnp.sin(phi), 2 * jnp.cos(phi)], axis=1)
        return eps * self.scale + loc


@dataclasses.dataclass(frozen=True)
class RingMixture:
    """Concentric rings; ref ``target.py:176-195``."""

    n_rings: int = 2
    n_dims: int = 2
    max_log_prob: float = 0.0

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        scale = 1 / 4 / self.n_rings
        r = jnp.linalg.norm(z, axis=1)
        i = jnp.arange(1, self.n_rings + 1)
        d = ((r[:, None] - 2 / self.n_rings * i) ** 2) / (2 * scale**2)
        return jax.scipy.special.logsumexp(-d, axis=1)

    def sample(self, key: jax.Array, num_samples: int) -> jnp.ndarray:
        return rejection_sample(self, key, num_samples)


@dataclasses.dataclass(frozen=True)
class ConditionalDiagGaussian:
    """Mean/std conditioned Gaussian; ref ``target.py:198-225``."""

    def log_prob(self, z, context):
        d = z.shape[-1]
        loc, scale = context[:, :d], context[:, d:]
        return (-0.5 * d * jnp.log(2 * jnp.pi)
                - jnp.sum(jnp.log(scale)
                          + 0.5 * ((z - loc) / scale) ** 2, axis=-1))

    def sample(self, key, num_samples, context):
        d = context.shape[-1] // 2
        loc, scale = context[:, :d], context[:, d:]
        eps = jax.random.normal(key, (num_samples, d))
        return loc + scale * eps


@dataclasses.dataclass(frozen=True)
class TwoIndependent:
    """Product of two independent targets on split coords; ref ``target.py:76-96``."""

    target1: Any
    target2: Any
    split: int

    def log_prob(self, z):
        return (self.target1.log_prob(z[:, : self.split])
                + self.target2.log_prob(z[:, self.split:]))

    def sample(self, key, num_samples):
        k1, k2 = jax.random.split(key)
        return jnp.concatenate([self.target1.sample(k1, num_samples),
                                self.target2.sample(k2, num_samples)], axis=1)


@dataclasses.dataclass(frozen=True)
class TwoModes:
    """Two-mode prior; ref ``prior.py:107-149``."""

    loc: float
    scale: float

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        a = jnp.abs(z[:, 0])
        eps = abs(self.loc)
        return (-0.5 * ((jnp.linalg.norm(z, axis=1) - self.loc)
                        / (2 * self.scale)) ** 2
                - 0.5 * ((a - eps) / (3 * self.scale)) ** 2
                + jnp.log1p(jnp.exp(-2 * (a * eps) / (3 * self.scale) ** 2)))


@dataclasses.dataclass(frozen=True)
class Sinusoidal:
    """Sinusoidal ridge; ref ``prior.py:152-196``."""

    scale: float
    period: float

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        z_ = jnp.moveaxis(z, -1, 0) if z.ndim > 1 else z
        w1 = jnp.sin(2 * jnp.pi / self.period * z_[0])
        norm4 = jnp.sum(jnp.abs(z_) ** 4, axis=0) ** 0.25
        return (-0.5 * ((z_[1] - w1) / self.scale) ** 2
                - 0.5 * (norm4 / (20 * self.scale)) ** 4)


@dataclasses.dataclass(frozen=True)
class SinusoidalGap:
    """Sinusoidal ridge with a gap; ref ``prior.py:197-247``."""

    scale: float
    period: float

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        z_ = jnp.moveaxis(z, -1, 0) if z.ndim > 1 else z
        w1 = jnp.sin(2 * jnp.pi / self.period * z_[0])
        w2 = 3 * jnp.exp(-0.5 * ((z_[0] - 1) / 0.6) ** 2)
        eps = 1e-12
        a = -0.5 * ((z_[1] - w1) / self.scale) ** 2
        b = -0.5 * ((z_[1] - w1 + w2) / self.scale) ** 2
        norm4 = jnp.sum(jnp.abs(z_) ** 4, axis=0) ** 0.25
        return (jnp.logaddexp(a, b)
                - 0.5 * (norm4 / (20 * self.scale)) ** 4 + eps)


@dataclasses.dataclass(frozen=True)
class SinusoidalSplit:
    """Sinusoidal ridge split in two; ref ``prior.py:248-298``."""

    scale: float
    period: float

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        z_ = jnp.moveaxis(z, -1, 0) if z.ndim > 1 else z
        w1 = jnp.sin(2 * jnp.pi / self.period * z_[0])
        w3 = 3 * jax.nn.sigmoid((z_[0] - 1) / 0.3)
        a = -0.5 * ((z_[1] - w1) / self.scale) ** 2
        b = -0.5 * ((z_[1] - w1 + w3) / self.scale) ** 2
        norm4 = jnp.sum(jnp.abs(z_) ** 4, axis=0) ** 0.25
        return (jnp.logaddexp(a, b)
                - 0.5 * (norm4 / (20 * self.scale)) ** 4)


@dataclasses.dataclass(frozen=True)
class Smiley:
    """Smiley-face density; ref ``prior.py:299-327``."""

    scale: float

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        z_ = jnp.moveaxis(z, -1, 0) if z.ndim > 1 else z
        return (-0.5 * ((jnp.linalg.norm(z, axis=-1) - 1.2)
                        / (2 * self.scale)) ** 2
                - 0.5 * ((jnp.abs(z_[1] + 0.8) - 1.2) / (2 * self.scale)) ** 2)


class ImagePrior:
    """Image-intensity density on a 2D rectangle; ref ``prior.py:21-104``.

    The (normalized, eps-floored) pixel intensities of a grayscale image
    define an unnormalized log-density over ``x_range x y_range``;
    ``log_prob`` is nearest-pixel lookup, ``sample`` is batched rejection
    sampling against the intensity map (one fixed-size device batch per
    round instead of the reference's grow-until-full while loop).
    """

    def __init__(self, image, x_range=(-3.0, 3.0), y_range=(-3.0, 3.0),
                 eps: float = 1e-10):
        img = np.flip(np.asarray(image, dtype=np.float64), 0).T + eps
        img = img / img.max()
        self.image = jnp.asarray(img, dtype=jnp.float32)
        self.density = jnp.asarray(np.log(img / img.sum()),
                                   dtype=jnp.float32)
        self.shape = np.asarray(img.shape)
        self.shift = jnp.asarray([x_range[0], y_range[0]])
        self.scale = jnp.asarray([x_range[1] - x_range[0],
                                  y_range[1] - y_range[0]])

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        z_ = jnp.clip((z - self.shift) / self.scale, 0.0, 1.0)
        ind = (z_ * (self.shape - 1)).astype(jnp.int32)
        return self.density[ind[:, 0], ind[:, 1]]

    def sample(self, key: jax.Array, num_samples: int,
               oversample: int = 8) -> jnp.ndarray:
        """Per-round acceptance is mean(img)/max(img); for mostly-dark
        images raise ``oversample`` (shortfall is filled by cycling the
        accepted points, see ``_take_accepted``)."""
        k_prop, k_acc = jax.random.split(key)
        n_prop = oversample * num_samples
        z_ = jax.random.uniform(k_prop, (n_prop, 2))
        ind = (z_ * (self.shape - 1)).astype(jnp.int32)
        intensity = self.image[ind[:, 0], ind[:, 1]]
        accept = intensity > jax.random.uniform(k_acc, (n_prop,))
        return _take_accepted(z_, accept, num_samples) * self.scale + self.shift


@dataclasses.dataclass(frozen=True)
class LinearInterpolation:
    """Geometric interpolation of two densities; ref ``linear_interpolation.py``.

    log_prob = alpha * dist1.log_prob + (1 - alpha) * dist2.log_prob
    """

    dist1: Any
    dist2: Any
    alpha: float

    def log_prob(self, z):
        return (self.alpha * self.dist1.log_prob(z)
                + (1.0 - self.alpha) * self.dist2.log_prob(z))
