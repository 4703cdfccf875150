"""Autoregressive flows: MADE-parameterized affine and RQ-spline transforms.

Equivalents of:

* ``nets/made.py``                      — MADE masked MLP (``made.py:217-304``)
* ``flows/affine/autoregressive.py``    — ``Autoregressive`` base +
  ``MaskedAffineAutoregressive`` (``autoregressive.py:10-128``)
* ``flows/neural_spline/autoregressive.py`` —
  ``MaskedPiecewiseRationalQuadraticAutoregressive`` (``autoregressive.py:17-134``)

Design: the MADE masks are static numpy; the autoregressive *inverse* (one
feature at a time) is a ``lax.fori_loop`` over features — D sequential net
evaluations, exactly the algorithmic cost of the reference's loop
(``affine/autoregressive.py:29-38``) but jitted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.nets import _linear, _linear_init
from flowstate.ops.splines import (
    IDENTITY_DERIVATIVE_CONSTANT,
    unconstrained_rational_quadratic_spline,
    rational_quadratic_spline,
)


@dataclasses.dataclass(frozen=True)
class MADE:
    """Masked autoencoder for distribution estimation; ref ``nets/made.py``.

    Sequential degrees (no random masks); plain masked MLP stack (the
    reference's residual variant differs only in skip wiring).
    Output has ``features * output_multiplier`` units whose unit k*F + i
    depends only on inputs < i.
    """

    features: int
    hidden_features: int
    num_blocks: int = 2
    output_multiplier: int = 2
    periodic_scale: Optional[float] = None  # cos/sin featurization scale

    def _degrees(self):
        in_deg = np.arange(1, self.features + 1)
        hid_deg = (np.arange(self.hidden_features) % max(1, self.features - 1)) + 1
        # interleaved grouping: output unit i*M + k -> feature i
        # (reference utils/nn.py:186-192 tile + made.py:56-60)
        out_deg = np.repeat(np.arange(1, self.features + 1),
                            self.output_multiplier)
        return in_deg, hid_deg, out_deg

    def _masks(self):
        in_deg, hid_deg, out_deg = self._degrees()
        if self.periodic_scale is not None:
            # cos/sin featurization doubles the input width; degrees repeat
            in_deg = np.tile(in_deg, 2)
        masks = [(hid_deg[None, :] >= in_deg[:, None]).astype(np.float32)]
        for _ in range(self.num_blocks - 1):
            masks.append(
                (hid_deg[None, :] >= hid_deg[:, None]).astype(np.float32))
        masks.append((out_deg[None, :] > hid_deg[:, None]).astype(np.float32))
        return masks

    def init_params(self, key: jax.Array, init_identity: bool = False,
                    identity_bias: float = 0.0):
        masks = self._masks()
        keys = jax.random.split(key, len(masks))
        layers = []
        for k, m in zip(keys, masks):
            layers.append(_linear_init(k, m.shape[0], m.shape[1]))
        if init_identity:
            layers[-1] = {"w": jnp.zeros_like(layers[-1]["w"]),
                          "b": jnp.full_like(layers[-1]["b"], identity_bias)}
        return layers

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        if self.periodic_scale is not None:
            x = jnp.concatenate([jnp.cos(self.periodic_scale * x),
                                 jnp.sin(self.periodic_scale * x)], axis=-1)
        masks = self._masks()
        for i, (p, m) in enumerate(zip(params, masks)):
            x = jnp.dot(x, p["w"] * jnp.asarray(m),
                        preferred_element_type=jnp.float32) + p["b"]
            if i < len(masks) - 1:
                x = jax.nn.relu(x)
        return x


@dataclasses.dataclass(frozen=True)
class MaskedAffineAutoregressive:
    """IAF/MAF-style affine autoregressive flow; ref ``affine/autoregressive.py:50-128``."""

    features: int
    hidden_features: int
    num_blocks: int = 2

    def _net(self) -> MADE:
        return MADE(self.features, self.hidden_features, self.num_blocks,
                    output_multiplier=2)

    def init_params(self, key: jax.Array):
        return {"made": self._net().init_params(key)}

    def _unconstrained(self, params, x):
        raw = self._net().apply(params["made"], x)
        raw = raw.reshape(-1, self.features, 2)
        # sigmoid(s+2)+1e-3 scale map (affine/autoregressive.py:103, 114)
        scale = jax.nn.sigmoid(raw[..., 0] + 2.0) + 1e-3
        return raw[..., 1], jnp.log(scale)

    def forward(self, params, z):
        """Data direction per the reference convention (one pass)."""
        shift, log_scale = self._unconstrained(params, z)
        z_ = z * jnp.exp(log_scale) + shift
        return z_, jnp.sum(log_scale, axis=-1)

    def inverse(self, params, z):
        """Sequential inverse: feature i depends on features < i."""

        def body(i, x):
            shift, log_scale = self._unconstrained(params, x)
            xi = (z[:, i] - shift[:, i]) * jnp.exp(-log_scale[:, i])
            return x.at[:, i].set(xi)

        x = jax.lax.fori_loop(0, self.features, body, jnp.zeros_like(z))
        _, log_scale = self._unconstrained(params, x)
        return x, -jnp.sum(log_scale, axis=-1)


@dataclasses.dataclass(frozen=True)
class MaskedPiecewiseRQSAutoregressive:
    """Autoregressive RQ-spline flow; ref ``neural_spline/autoregressive.py:17-134``.

    ``tails``: None (compact interval), "linear", "circular", or per-dim list
    (with the wrapper's circular periodic featurization of the MADE input,
    ``autoregressive.py:44-55``).
    """

    features: int
    hidden_features: int
    num_bins: int = 10
    tails: Optional[object] = None
    tail_bound: float = 1.0
    num_blocks: int = 2
    init_identity: bool = True

    @property
    def _multiplier(self) -> int:
        if self.tails == "linear":
            return self.num_bins * 3 - 1
        elif self.tails == "circular":
            return self.num_bins * 3
        return self.num_bins * 3 + 1

    def _net(self) -> MADE:
        scale = None
        if isinstance(self.tails, (list, tuple)) or self.tails == "circular":
            scale = float(np.pi / self.tail_bound)
        return MADE(self.features, self.hidden_features, self.num_blocks,
                    output_multiplier=self._multiplier,
                    periodic_scale=scale)

    def init_params(self, key: jax.Array):
        return {"made": self._net().init_params(
            key, init_identity=self.init_identity,
            identity_bias=IDENTITY_DERIVATIVE_CONSTANT)}

    def _elementwise(self, params, cond_input, x, inverse: bool):
        raw = self._net().apply(params["made"], cond_input)
        b = x.shape[0]
        # MADE output unit k*F + i conditions on inputs < i; regroup to
        # (B, F, multiplier)
        raw = raw.reshape(b, self.features, self._multiplier)
        nb = self.num_bins
        scale = 1.0 / np.sqrt(self.hidden_features)
        uw = raw[..., :nb] * scale
        uh = raw[..., nb:2 * nb] * scale
        ud = raw[..., 2 * nb:]
        if self.tails is None:
            out, ld = rational_quadratic_spline(
                x, uw, uh, ud, inverse=inverse, left=-self.tail_bound,
                right=self.tail_bound, bottom=-self.tail_bound,
                top=self.tail_bound)
        else:
            out, ld = unconstrained_rational_quadratic_spline(
                x, uw, uh, ud, inverse=inverse, tails=self.tails,
                tail_bound=self.tail_bound)
        return out, ld

    def forward(self, params, z):
        out, ld = self._elementwise(params, z, z, inverse=False)
        return out, jnp.sum(ld, axis=-1)

    def inverse(self, params, z):
        def body(i, x):
            out, _ = self._elementwise(params, x, z, inverse=True)
            return x.at[:, i].set(out[:, i])

        x = jax.lax.fori_loop(0, self.features, body, jnp.zeros_like(z))
        _, ld = self._elementwise(params, x, x, inverse=False)
        return x, -jnp.sum(ld, axis=-1)


@dataclasses.dataclass(frozen=True)
class AutoregressiveRationalQuadraticSpline:
    """Linear-tail autoregressive NSF; ref ``neural_spline/wrapper.py:278-336``.

    Thin wrapper over :class:`MaskedPiecewiseRQSAutoregressive` with the
    reference's direction convention: the flow ``forward`` (base → target,
    used in sampling) is the inner transform's sequential inverse, and the
    flow ``inverse`` (density evaluation) is the fast one-pass direction —
    MAF semantics (``wrapper.py:331-336``).
    """

    num_input_channels: int
    num_blocks: int
    num_hidden_channels: int
    num_bins: int = 8
    tail_bound: float = 3.0
    init_identity: bool = True

    def _inner(self) -> MaskedPiecewiseRQSAutoregressive:
        return MaskedPiecewiseRQSAutoregressive(
            features=self.num_input_channels,
            hidden_features=self.num_hidden_channels,
            num_bins=self.num_bins, tails="linear",
            tail_bound=self.tail_bound, num_blocks=self.num_blocks,
            init_identity=self.init_identity)

    def init_params(self, key: jax.Array):
        return self._inner().init_params(key)

    def forward(self, params, z):
        return self._inner().inverse(params, z)

    def inverse(self, params, z):
        return self._inner().forward(params, z)


@dataclasses.dataclass(frozen=True)
class CircularAutoregressiveRationalQuadraticSpline:
    """Circular-tail autoregressive NSF; ref ``wrapper.py:339-403``.

    Per-dim tails: ``"circular"`` for indices in ``ind_circ``, ``"linear"``
    otherwise (``wrapper.py:377-379``); the MADE input gets the cos/sin
    periodic featurization at scale π/tail_bound applied to **all** dims —
    matching the fork's modified ``PeriodicFeaturesElementwise``, whose
    forward ignores ``ind`` and featurizes the whole input
    (``utils/nn.py:120-137``; upstream normflows featurizes only the
    circular dims).  Same MAF direction convention as
    :class:`AutoregressiveRationalQuadraticSpline`.
    """

    num_input_channels: int
    num_blocks: int
    num_hidden_channels: int
    ind_circ: tuple = ()
    num_bins: int = 8
    tail_bound: float = 3.0
    init_identity: bool = True

    def _inner(self) -> MaskedPiecewiseRQSAutoregressive:
        circ = set(self.ind_circ)
        tails = tuple("circular" if i in circ else "linear"
                      for i in range(self.num_input_channels))
        return MaskedPiecewiseRQSAutoregressive(
            features=self.num_input_channels,
            hidden_features=self.num_hidden_channels,
            num_bins=self.num_bins, tails=tails,
            tail_bound=self.tail_bound, num_blocks=self.num_blocks,
            init_identity=self.init_identity)

    def init_params(self, key: jax.Array):
        return self._inner().init_params(key)

    def forward(self, params, z):
        return self._inner().inverse(params, z)

    def inverse(self, params, z):
        return self._inner().forward(params, z)
