"""Mixing / permutation / invertible-linear flow layers.

Equivalents of ``NF/normflows/flows/mixing.py``:

* ``Permute``          — shuffle or swap channels (``mixing.py:9-55``)
* ``InvertibleAffine`` — D x D invertible linear with optional LU
  parameterization (``mixing.py:136-212``)
* ``LULinearPermute``  — random permutation + LU-decomposed linear
  (``mixing.py:547-563``; the _Linear/_LULinear machinery at :274-545)
* ``Invertible1x1Conv``— Glow's 1x1 conv for NCHW images (``mixing.py:57-134``)

The LU parameterization keeps the log-determinant O(D) (sum of log
|diag(U)|) and triangular solves replace matrix inversion.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Permute:
    """Channel permutation; ref ``mixing.py:9-55``."""

    num_channels: int
    mode: str = "shuffle"
    seed: int = 0

    def _perm(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.permutation(self.num_channels)

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        if self.mode == "shuffle":
            return z[:, self._perm()], log_det
        elif self.mode == "swap":
            h = self.num_channels // 2
            return jnp.concatenate([z[:, h:], z[:, :h]], axis=1), log_det
        raise NotImplementedError(f"mode {self.mode} is not implemented.")

    def inverse(self, params, z):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        if self.mode == "shuffle":
            perm = self._perm()
            inv = np.empty_like(perm)
            inv[perm] = np.arange(self.num_channels)
            return z[:, inv], log_det
        elif self.mode == "swap":
            h = (self.num_channels + 1) // 2
            return jnp.concatenate([z[:, h:], z[:, :h]], axis=1), log_det
        raise NotImplementedError(f"mode {self.mode} is not implemented.")


def _lu_assemble(params, dim):
    """W = P L U with unit-diagonal L and parameterized U diagonal."""
    lower = jnp.tril(params["lower"], k=-1) + jnp.eye(dim)
    upper = jnp.triu(params["upper"], k=1) + jnp.diag(
        jnp.exp(params["log_upper_diag"]) * params["sign_upper_diag"])
    return lower, upper


@dataclasses.dataclass(frozen=True)
class InvertibleAffine:
    """D x D invertible linear layer; ref ``mixing.py:136-212``.

    ``use_lu=True`` (reference default) parameterizes W = P L U with a fixed
    random permutation P, giving O(D) log-det and triangular-solve inverses.
    """

    dim: int
    use_lu: bool = True
    seed: int = 0

    def _permutation(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.permutation(self.dim)

    def init_params(self, key: jax.Array):
        if not self.use_lu:
            # random orthogonal init (reference uses QR of random normal)
            q, _ = jnp.linalg.qr(jax.random.normal(key, (self.dim, self.dim)))
            return {"weight": q}
        # near-identity init with small noise (nflows-style _LULinear init)
        k1, k2 = jax.random.split(key)
        eps = 1e-3 / np.sqrt(self.dim)
        return {
            "lower": eps * jax.random.normal(k1, (self.dim, self.dim)),
            "upper": eps * jax.random.normal(k2, (self.dim, self.dim)),
            "log_upper_diag": jnp.zeros((self.dim,)),
            "sign_upper_diag": jnp.ones((self.dim,)),
        }

    def _weight_logdet(self, params):
        if not self.use_lu:
            w = params["weight"]
            sign, logdet = jnp.linalg.slogdet(w)
            return w, logdet
        lower, upper = _lu_assemble(params, self.dim)
        w = lower @ upper
        logdet = jnp.sum(params["log_upper_diag"])
        return w, logdet

    def forward(self, params, z):
        w, logdet = self._weight_logdet(params)
        z_ = z @ w.T
        if self.use_lu:
            # the fixed random permutation P of W = P L U (|det P| = 1)
            z_ = z_[:, self._permutation()]
        return z_, jnp.broadcast_to(logdet, (z.shape[0],))

    def inverse(self, params, z):
        if self.use_lu:
            perm = self._permutation()
            inv = np.empty_like(perm)
            inv[perm] = np.arange(self.dim)
            z = z[:, inv]
            lower, upper = _lu_assemble(params, self.dim)
            # solve (L U) x = z^T  via two triangular solves
            y = jax.scipy.linalg.solve_triangular(lower, z.T, lower=True)
            x = jax.scipy.linalg.solve_triangular(upper, y, lower=False)
            z_ = x.T
            logdet = -jnp.sum(params["log_upper_diag"])
        else:
            w = params["weight"]
            z_ = jnp.linalg.solve(w, z.T).T
            _, ld = jnp.linalg.slogdet(w)
            logdet = -ld
        return z_, jnp.broadcast_to(logdet, (z.shape[0],))


@dataclasses.dataclass(frozen=True)
class LULinearPermute:
    """Fixed random permutation followed by an LU linear; ref ``mixing.py:547-563``."""

    dim: int
    seed: int = 0

    def _inner(self) -> InvertibleAffine:
        return InvertibleAffine(self.dim, use_lu=True, seed=self.seed)

    def _perm(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 1)
        return rng.permutation(self.dim)

    def init_params(self, key: jax.Array):
        return self._inner().init_params(key)

    def forward(self, params, z):
        z = z[:, self._perm()]
        return self._inner().forward(params, z)

    def inverse(self, params, z):
        z, log_det = self._inner().inverse(params, z)
        perm = self._perm()
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.dim)
        return z[:, inv], log_det


@dataclasses.dataclass(frozen=True)
class Invertible1x1Conv:
    """Glow's invertible 1x1 convolution on NCHW images; ref ``mixing.py:57-134``."""

    num_channels: int
    use_lu: bool = True
    seed: int = 0

    def _inner(self) -> InvertibleAffine:
        return InvertibleAffine(self.num_channels, use_lu=self.use_lu,
                                seed=self.seed)

    def init_params(self, key: jax.Array):
        return self._inner().init_params(key)

    def forward(self, params, z):
        b, c, h, w = z.shape
        flat = z.transpose(0, 2, 3, 1).reshape(-1, c)
        out, ld = self._inner().forward(params, flat)
        z_ = out.reshape(b, h, w, c).transpose(0, 3, 1, 2)
        return z_, ld.reshape(b, h * w).sum(axis=-1)

    def inverse(self, params, z):
        b, c, h, w = z.shape
        flat = z.transpose(0, 2, 3, 1).reshape(-1, c)
        out, ld = self._inner().inverse(params, flat)
        z_ = out.reshape(b, h, w, c).transpose(0, 3, 1, 2)
        return z_, ld.reshape(b, h * w).sum(axis=-1)
