"""Flow-library utilities: eval metrics, data transforms, geometry.

Equivalents of ``NF/normflows/utils``:

* ``bits_per_dim``        — ``utils/eval.py:5-34`` (logit-transform BPD)
* ``Logit / Jitter / Scale`` preprocessing — ``utils/preprocessing.py``
* ``compute_distances`` / ``remove_mean`` — ``utils/geometry.py:114-168``
* ``sum_except_batch``    — re-exported from coupling
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.coupling import sum_except_batch  # noqa: F401


def bits_per_dim(model, params, x: jnp.ndarray,
                 trans: str = "logit",
                 trans_param=(0.05,)) -> jnp.ndarray:
    """Bits/dim of a batch under a logit-preprocessed image model.

    Reference ``utils/eval.py:5-34``.
    """
    if trans != "logit":
        raise NotImplementedError(f"The transformation {trans} is not implemented.")
    dims = np.prod(x.shape[1:])
    log_q = model.log_prob(params, x)
    ls = jax.nn.log_sigmoid
    sig = sum_except_batch(ls(x) / np.log(2)) + sum_except_batch(
        ls(-x) / np.log(2))
    b = -log_q / dims / np.log(2) - np.log2(1 - trans_param[0]) + 8
    return b + sig / dims


def bits_per_dim_dataset(model, params, batches) -> float:
    """Average BPD over an iterable of batches; ref ``utils/eval.py:37-63``."""
    n, total = 0, 0.0
    for x in batches:
        b = np.asarray(bits_per_dim(model, params, x))
        total += np.nansum(b)
        n += len(b) - np.sum(np.isnan(b))
    return float(total / n)


@dataclasses.dataclass(frozen=True)
class Logit:
    """logit(alpha + (1-alpha) x); ref ``utils/preprocessing.py:4-27``."""

    alpha: float = 0.0

    def __call__(self, x):
        x_ = self.alpha + (1 - self.alpha) * x
        return jnp.log(x_ / (1 - x_))

    def inverse(self, x):
        return (jax.nn.sigmoid(x) - self.alpha) / (1 - self.alpha)


@dataclasses.dataclass(frozen=True)
class Jitter:
    """Uniform dequantization noise; ref ``utils/preprocessing.py:30-44``."""

    scale: float = 1.0 / 256

    def __call__(self, x, key: jax.Array):
        return x + jax.random.uniform(key, x.shape) * self.scale


@dataclasses.dataclass(frozen=True)
class Scale:
    """Constant rescale; ref ``utils/preprocessing.py:47-57``."""

    scale: float = 255.0 / 256.0

    def __call__(self, x):
        return x * self.scale


def compute_distances(x: jnp.ndarray, n_particles: int, n_dimensions: int,
                      remove_duplicates: bool = True) -> jnp.ndarray:
    """All pair distances of particle configurations.

    Reference ``utils/geometry.py:114-139`` (cdist + upper triangle).
    """
    x = x.reshape(-1, n_particles, n_dimensions)
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1), 1e-24))
    if remove_duplicates:
        iu, ju = np.triu_indices(n_particles, k=1)
        return dist[:, iu, ju]
    return dist


def distances_from_vectors(r: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """(..., N, N) distance matrix from (..., N, N, D) difference vectors.

    Reference ``utils/geometry.py:93-111`` (eps-regularized norm).
    """
    return jnp.sqrt(jnp.sum(r * r, axis=-1) + eps)


def remove_mean(samples: jnp.ndarray, n_particles: int,
                n_dimensions: int) -> jnp.ndarray:
    """Mean-free configurations; ref ``utils/geometry.py:144-168``."""
    shape = samples.shape
    x = samples.reshape(-1, n_particles, n_dimensions)
    x = x - jnp.mean(x, axis=1, keepdims=True)
    return x.reshape(shape)
