"""Invertible residual flows (i-ResNet) with Lipschitz-constrained nets.

Equivalents of ``NF/normflows/flows/residual.py`` and
``nets/lipschitz.py``:

* ``LipschitzMLP``  — MLP of spectral-normalized linears with LipSwish
  activations (``lipschitz.py:14-68``, ``InducedNormLinear`` :132-293).
  Spectral norm via power iteration; the iteration vectors live in the
  params pytree and are refreshed by the explicit ``update_lipschitz``
  (the functional counterpart of ``utils/optim.py:28-31``).
* ``Residual``      — the invertible residual block f(x) = x + g(x)
  (``residual.py:12-77``) with three log-det estimators mirroring
  ``iResBlock._logdetgrad`` (``residual.py:144-220``):
    - ``exact``: log|det(I + J)| by full Jacobian (any small D; the
      reference's brute_force covers only D=2),
    - ``series``: truncated power series  sum_k (-1)^(k+1)/k tr(J^k) with
      Hutchinson trace estimation (the biased n_power_series mode),
    - ``unbiased``: the russian-roulette estimator (``residual.py:164-200``,
      helpers :402-434): a random truncation level N is drawn from a
      geometric/Poisson distribution and term k is reweighted by
      1{N >= k - n_exact}/P(N >= k - n_exact), making the truncated series
      unbiased.  Static-shape note: the reference truncates at the sampled N
      (dynamic); here the series is unrolled to a static ``n_power_series``
      cap and the roulette enters as traced 0/1·weight masks, so one
      compiled program serves every draw.
  and the Banach fixed-point inverse (``residual.py:133-142``) as a fixed
  ``lax.fori_loop`` (static iteration count — jit-friendly).

The reference's ``MemoryEfficientLogDetEstimator``/``mem_eff_wrapper``
(``residual.py:282-397``) is a hand-written backward pass that avoids
storing the power-series graph; under XLA the same trade is
``jax.checkpoint`` on the estimator, so no custom VJP is carried.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.nets import _linear_init


def lipswish(x: jnp.ndarray) -> jnp.ndarray:
    """LipSwish activation: swish / 1.1 (Lipschitz constant 1)."""
    return jax.nn.silu(x) / 1.1


def leaky_elu(x: jnp.ndarray, a: float = 0.3) -> jnp.ndarray:
    """Leaky ELU used by Lipschitz nets; ref ``nets/lipschitz.py:697-698``."""
    return a * x + (1 - a) * jax.nn.elu(x)


def asym_squash(x: jnp.ndarray) -> jnp.ndarray:
    """Asymmetric squashing to (1, 5); ref ``nets/lipschitz.py:701-702``."""
    return jnp.tanh(-leaky_elu(-x + 0.5493061829986572)) * 2.0 + 3.0


def geometric_sample(key: jax.Array, p: float, shape=()) -> jnp.ndarray:
    """Draw N ~ Geometric(p) on {1, 2, ...} (ref ``residual.py:405-406``)."""
    u = jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny)
    return jnp.floor(jnp.log(u) / jnp.log1p(-p)).astype(jnp.int32) + 1


def poisson_sample(key: jax.Array, lamb: float, shape=()) -> jnp.ndarray:
    """Draw N ~ Poisson(lamb) (ref ``residual.py:417-418``)."""
    return jax.random.poisson(key, lamb, shape).astype(jnp.int32)


def geometric_1mcdf(p: float, k: int, offset: int) -> float:
    """P(N >= k - offset) for N ~ Geometric(p); ref ``residual.py:409-414``.

    Static Python floats: k/offset are loop constants under jit.
    """
    if k <= offset:
        return 1.0
    k = k - offset
    return float((1.0 - p) ** max(k - 1, 0))


def poisson_1mcdf(lamb: float, k: int, offset: int) -> float:
    """P(N >= k - offset) for N ~ Poisson(lamb); ref ``residual.py:421-429``."""
    import math

    if k <= offset:
        return 1.0
    k = k - offset
    total = sum(lamb ** i / math.factorial(i) for i in range(k))
    return float(1.0 - np.exp(-lamb) * total)


def batch_jacobian(f, x: jnp.ndarray) -> jnp.ndarray:
    """(B, D, D) Jacobian of a batched map; ref ``residual.py:265-273``."""
    return jax.vmap(jax.jacfwd(lambda v: f(v[None, :])[0]))(x)


def batch_trace(m: jnp.ndarray) -> jnp.ndarray:
    """Batched matrix trace; ref ``residual.py:276-277``."""
    return jnp.trace(m, axis1=-2, axis2=-1)


@dataclasses.dataclass(frozen=True)
class LipschitzMLP:
    """MLP with spectrally-normalized weights (Lipschitz < coeff)."""

    channels: Tuple[int, ...]   # (in, hidden..., out)
    coeff: float = 0.97
    n_power_iter: int = 1

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.channels) - 1)
        layers = []
        for i, k in enumerate(keys):
            k1, k2 = jax.random.split(k)
            lin = _linear_init(k1, self.channels[i], self.channels[i + 1])
            u = jax.random.normal(k2, (self.channels[i + 1],))
            layers.append({"w": lin["w"], "b": lin["b"],
                           "u": u / jnp.linalg.norm(u)})
        return layers

    def _normalized_w(self, layer):
        """Spectral norm estimate from the stored power-iteration vector."""
        w, u = layer["w"], layer["u"]
        v = w @ u
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
        u_new = v @ w
        sigma = jnp.maximum(
            jnp.linalg.norm(u_new), 1e-12)
        factor = jnp.minimum(1.0, self.coeff / sigma)
        return w * factor

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        for i, layer in enumerate(params):
            x = x @ self._normalized_w(layer) + layer["b"]
            if i < len(params) - 1:
                x = lipswish(x)
        return x

    def update_lipschitz(self, params, n_iterations: int = 5):
        """Refresh the power-iteration vectors (utils/optim.py:28-31)."""
        new = []
        for layer in params:
            w, u = layer["w"], layer["u"]
            for _ in range(n_iterations):
                v = w @ u
                v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
                u = v @ w
                u = u / jnp.maximum(jnp.linalg.norm(u), 1e-12)
            new.append({**layer, "u": u})
        return new


@dataclasses.dataclass(frozen=True)
class Residual:
    """Invertible residual block; ref ``residual.py:12-77``.

    ``reverse=True`` (reference default): ``forward`` applies the fixed-point
    inverse of x + g(x) and ``inverse`` applies x + g(x).
    """

    net: LipschitzMLP
    reverse: bool = True
    estimator: str = "exact"      # 'exact' | 'series' | 'unbiased'
    n_power_series: int = 8       # truncation ('series') / static cap ('unbiased')
    n_trace_samples: int = 1
    fixed_point_iters: int = 50
    dim: int = 0                  # required for 'exact'
    n_dist: str = "geometric"     # roulette distribution ('unbiased')
    geom_p: float = 0.5
    lamb: float = 2.0
    n_exact_terms: int = 2        # always-kept leading terms ('unbiased')

    def init_params(self, key: jax.Array):
        return {"net": self.net.init_params(key)}

    # -- log-det estimators ------------------------------------------------

    def _logdet_exact(self, params, x):
        def g_single(v):
            return self.net.apply(params["net"], v[None, :])[0]

        def per_sample(v):
            J = jax.jacfwd(g_single)(v)
            _, ld = jnp.linalg.slogdet(jnp.eye(v.shape[0]) + J)
            return ld

        return jax.vmap(per_sample)(x)

    def _logdet_series(self, params, x, key):
        """Hutchinson-estimated truncated power series of tr(log(I+J))."""
        def g(v):
            return self.net.apply(params["net"], v)

        eps = jax.random.rademacher(
            key, (self.n_trace_samples, *x.shape), dtype=x.dtype)

        def one_probe(e):
            # iteratively compute v_k = J^k e via vjp
            _, vjp = jax.vjp(g, x)
            ld = jnp.zeros(x.shape[0], dtype=x.dtype)
            v = e
            for k in range(1, self.n_power_series + 1):
                (v,) = vjp(v)
                coeff = (-1.0) ** (k + 1) / k
                ld = ld + coeff * jnp.sum(v * e, axis=-1)
            return ld

        return jnp.mean(jax.vmap(one_probe)(eps), axis=0)

    def _logdet_unbiased(self, params, x, key):
        """Russian-roulette unbiased power series (ref ``residual.py:164-200``).

        The series runs to the static cap ``n_power_series``; the sampled
        truncation level enters as per-term weights
        1{k <= N + n_exact} / P(N >= k - n_exact), so a term past the cap is
        a (documented) residual bias that vanishes as the cap grows —
        trade taken to keep one compiled program for all draws.
        """
        k_n, k_eps = jax.random.split(key)
        if self.n_dist == "geometric":
            n = geometric_sample(k_n, self.geom_p)
            rcdf = lambda k: geometric_1mcdf(self.geom_p, k, self.n_exact_terms)
        elif self.n_dist == "poisson":
            n = poisson_sample(k_n, self.lamb)
            rcdf = lambda k: poisson_1mcdf(self.lamb, k, self.n_exact_terms)
        else:
            raise ValueError(f"unknown n_dist {self.n_dist!r}")

        def g(v):
            return self.net.apply(params["net"], v)

        eps = jax.random.rademacher(
            k_eps, (self.n_trace_samples, *x.shape), dtype=x.dtype)

        def one_probe(e):
            _, vjp = jax.vjp(g, x)
            ld = jnp.zeros(x.shape[0], dtype=x.dtype)
            v = e
            for k in range(1, self.n_power_series + 1):
                (v,) = vjp(v)
                keep = (k - self.n_exact_terms <= n).astype(x.dtype)
                coeff = (-1.0) ** (k + 1) / k * keep / rcdf(k)
                ld = ld + coeff * jnp.sum(v * e, axis=-1)
            return ld

        return jnp.mean(jax.vmap(one_probe)(eps), axis=0)

    def _logdetgrad(self, params, x, key=None):
        if self.estimator == "exact":
            return self._logdet_exact(params, x)
        if self.estimator == "unbiased":
            if key is None:
                raise ValueError(
                    "estimator='unbiased' needs a fresh PRNG key per call "
                    "(pass key= to forward/inverse); with a fixed key the "
                    "roulette draw repeats and the estimator is biased")
            return self._logdet_unbiased(params, x, key)
        if self.estimator != "series":
            raise ValueError(f"unknown estimator {self.estimator!r}")
        if key is None:
            key = jax.random.key(0)  # deterministic probes (documented)
        return self._logdet_series(params, x, key)

    # -- the residual map --------------------------------------------------

    def _apply_map(self, params, x, key=None):
        g = self.net.apply(params["net"], x)
        return x + g, self._logdetgrad(params, x, key)

    def _inverse_fixed_point(self, params, y):
        """Banach iteration x <- y - g(x); ref ``residual.py:133-142``."""
        def body(_, x):
            return y - self.net.apply(params["net"], x)

        x0 = y - self.net.apply(params["net"], y)
        return jax.lax.fori_loop(0, self.fixed_point_iters, body, x0)

    def forward(self, params, z, key=None):
        if self.reverse:
            x = self._inverse_fixed_point(params, z)
            _, ld = self._apply_map(params, x, key)
            return x, -ld
        return self._apply_map(params, z, key)

    def inverse(self, params, z, key=None):
        if self.reverse:
            return self._apply_map(params, z, key)
        x = self._inverse_fixed_point(params, z)
        _, ld = self._apply_map(params, x, key)
        return x, -ld


@dataclasses.dataclass(frozen=True)
class LipschitzCNN:
    """CNN of spectrally-normalized convs with LipSwish activations.

    Reference ``nets/lipschitz.py:70-130`` (``LipschitzCNN`` over
    ``InducedNormConv2d``).  Spectral norm of each conv is estimated via
    power iteration on the full input-shaped operator (conv as a linear
    map), vectors stored in params and refreshed by ``update_lipschitz``.
    NCHW layout.
    """

    channels: Tuple[int, ...]          # (in, hidden..., out)
    kernel_size: Tuple[int, ...]       # per layer, odd
    spatial: Tuple[int, int]           # (H, W) the operator norm is taken on
    coeff: float = 0.97

    def _conv(self, w, x):
        k = w.shape[-1]
        pad = k // 2
        return jax.lax.conv_general_dilated(
            x, w, window_strides=(1, 1), padding=[(pad, pad), (pad, pad)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.float32)

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.channels) - 1)
        layers = []
        h, w_sp = self.spatial
        for i, k in enumerate(keys):
            k1, k2 = jax.random.split(k)
            kk = self.kernel_size[i]
            fan_in = self.channels[i] * kk * kk
            bound = 1.0 / np.sqrt(fan_in)
            w = jax.random.uniform(
                k1, (self.channels[i + 1], self.channels[i], kk, kk),
                minval=-bound, maxval=bound)
            u = jax.random.normal(k2, (1, self.channels[i + 1], h, w_sp))
            layers.append({"w": w, "b": jnp.zeros((self.channels[i + 1],)),
                           "u": u / jnp.linalg.norm(u)})
        return layers

    def _sigma(self, layer):
        """One-step power-iteration estimate of the conv operator norm."""
        w, u = layer["w"], layer["u"]
        # v = W^T u (transpose conv = conv with flipped, transposed kernel)
        w_t = jnp.flip(jnp.swapaxes(w, 0, 1), axis=(-1, -2))
        v = self._conv(w_t, u)
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
        u_new = self._conv(w, v)
        return jnp.maximum(jnp.linalg.norm(u_new), 1e-12)

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        for i, layer in enumerate(params):
            sigma = self._sigma(layer)
            factor = jnp.minimum(1.0, self.coeff / sigma)
            x = self._conv(layer["w"] * factor, x) \
                + layer["b"][None, :, None, None]
            if i < len(params) - 1:
                x = lipswish(x)
        return x

    def update_lipschitz(self, params, n_iterations: int = 5):
        new = []
        for layer in params:
            w, u = layer["w"], layer["u"]
            w_t = jnp.flip(jnp.swapaxes(w, 0, 1), axis=(-1, -2))
            for _ in range(n_iterations):
                v = self._conv(w_t, u)
                v = v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
                u = self._conv(w, v)
                u = u / jnp.maximum(jnp.linalg.norm(u), 1e-12)
            new.append({**layer, "u": u})
        return new
