"""Affine flow layers (RealNVP / Glow family), pure functional.

Equivalents of ``NF/normflows/flows/affine/coupling.py``:

* ``AffineConstFlow``    — per-dim learned scale/shift (``coupling.py:9-54``)
* ``CCAffineConst``      — class-conditional variant (``coupling.py:57-96``)
* ``AffineCoupling``     — RealNVP coupling on a (z1, z2) split
  (``coupling.py:99-171``) with 'exp' / 'sigmoid' / 'sigmoid_inv' scale maps
* ``MaskedAffineFlow``   — masked RealNVP: f(z) = b z + (1-b)(z e^{s(bz)} + t(bz))
  (``coupling.py:173-232``)
* ``AffineCouplingBlock``— Split -> AffineCoupling -> Merge (``coupling.py:235-267``)

Layers follow the framework protocol: frozen-dataclass config with
``init_params(key)`` and ``forward/inverse(params, z) -> (z, log_det)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class AffineConstFlow:
    """Learned constant scale/shift per dimension; ref ``coupling.py:9-54``."""

    dim: int
    scale: bool = True
    shift: bool = True

    def init_params(self, key: jax.Array):
        return {"s": jnp.zeros((self.dim,)), "t": jnp.zeros((self.dim,))}

    def forward(self, params, z):
        s = params["s"] if self.scale else jnp.zeros(self.dim)
        t = params["t"] if self.shift else jnp.zeros(self.dim)
        z_ = z * jnp.exp(s) + t
        log_det = jnp.broadcast_to(jnp.sum(s), (z.shape[0],))
        return z_, log_det

    def inverse(self, params, z):
        s = params["s"] if self.scale else jnp.zeros(self.dim)
        t = params["t"] if self.shift else jnp.zeros(self.dim)
        z_ = (z - t) * jnp.exp(-s)
        log_det = jnp.broadcast_to(-jnp.sum(s), (z.shape[0],))
        return z_, log_det


@dataclasses.dataclass(frozen=True)
class CCAffineConst:
    """Class-conditional affine const flow; ref ``coupling.py:57-96``.

    forward/inverse take an extra one-hot ``y`` (B, num_classes).
    """

    dim: int
    num_classes: int

    def init_params(self, key: jax.Array):
        return {"s": jnp.zeros((self.dim,)), "t": jnp.zeros((self.dim,)),
                "s_cc": jnp.zeros((self.num_classes, self.dim)),
                "t_cc": jnp.zeros((self.num_classes, self.dim))}

    def forward(self, params, z, y):
        s = params["s"] + y @ params["s_cc"]
        t = params["t"] + y @ params["t_cc"]
        z_ = z * jnp.exp(s) + t
        return z_, jnp.sum(s, axis=-1)

    def inverse(self, params, z, y):
        s = params["s"] + y @ params["s_cc"]
        t = params["t"] + y @ params["t_cc"]
        z_ = (z - t) * jnp.exp(-s)
        return z_, -jnp.sum(s, axis=-1)


def _affine_apply(z2, shift, scale_raw, scale_map: str, inverse: bool):
    """The three scale maps of the reference (``coupling.py:128-146``)."""
    if scale_map == "exp":
        if inverse:
            return (z2 - shift) * jnp.exp(-scale_raw), -scale_raw
        return z2 * jnp.exp(scale_raw) + shift, scale_raw
    if scale_map == "sigmoid":
        scale = jax.nn.sigmoid(scale_raw + 2.0)
        if inverse:
            return (z2 - shift) * scale, jnp.log(scale)
        return z2 / scale + shift, -jnp.log(scale)
    if scale_map == "sigmoid_inv":
        scale = jax.nn.sigmoid(scale_raw + 2.0)
        if inverse:
            return (z2 - shift) / scale, -jnp.log(scale)
        return z2 * scale + shift, jnp.log(scale)
    raise NotImplementedError(f"scale map {scale_map} not implemented")


@dataclasses.dataclass(frozen=True)
class AffineCoupling:
    """RealNVP coupling on a pre-split [z1, z2] pair; ref ``coupling.py:99-171``.

    ``param_map``: a net config exposing init_params/apply mapping z1 ->
    interleaved (shift, scale) channels (even idx = shift, odd = scale, as
    ``coupling.py:127-129``).
    """

    param_map: Any
    scale: bool = True
    scale_map: str = "exp"

    def init_params(self, key: jax.Array):
        return {"net": self.param_map.init_params(key)}

    def _params_for(self, params, z1):
        raw = self.param_map.apply(params["net"], z1)
        if self.scale:
            return raw[:, 0::2], raw[:, 1::2]
        return raw, None

    def forward(self, params, z: Tuple[jnp.ndarray, jnp.ndarray]):
        z1, z2 = z
        shift, scale_raw = self._params_for(params, z1)
        if self.scale:
            z2, ld = _affine_apply(z2, shift, scale_raw, self.scale_map,
                                   inverse=False)
            log_det = jnp.sum(ld, axis=-1)
        else:
            z2 = z2 + shift
            log_det = jnp.zeros(z2.shape[0], dtype=z2.dtype)
        return [z1, z2], log_det

    def inverse(self, params, z: Tuple[jnp.ndarray, jnp.ndarray]):
        z1, z2 = z
        shift, scale_raw = self._params_for(params, z1)
        if self.scale:
            z2, ld = _affine_apply(z2, shift, scale_raw, self.scale_map,
                                   inverse=True)
            log_det = jnp.sum(ld, axis=-1)
        else:
            z2 = z2 - shift
            log_det = jnp.zeros(z2.shape[0], dtype=z2.dtype)
        return [z1, z2], log_det


@dataclasses.dataclass(frozen=True)
class MaskedAffineFlow:
    """Masked RealNVP; ref ``coupling.py:173-232``.

    ``b``: 0/1 mask tuple; ``s_net``/``t_net``: net configs (None -> zeros,
    giving NICE-style volume-preserving shifts when s_net is None).
    Non-finite net outputs are mapped to NaN exactly like the reference
    (``coupling.py:216-220``).
    """

    b: Tuple[int, ...]
    s_net: Optional[Any] = None
    t_net: Optional[Any] = None

    def init_params(self, key: jax.Array):
        k1, k2 = jax.random.split(key)
        return {
            "s": self.s_net.init_params(k1) if self.s_net else None,
            "t": self.t_net.init_params(k2) if self.t_net else None,
        }

    def _maps(self, params, z_masked):
        nan = jnp.asarray(jnp.nan, dtype=z_masked.dtype)
        if self.s_net is not None:
            scale = self.s_net.apply(params["s"], z_masked)
            scale = jnp.where(jnp.isfinite(scale), scale, nan)
        else:
            scale = jnp.zeros_like(z_masked)
        if self.t_net is not None:
            trans = self.t_net.apply(params["t"], z_masked)
            trans = jnp.where(jnp.isfinite(trans), trans, nan)
        else:
            trans = jnp.zeros_like(z_masked)
        return scale, trans

    def forward(self, params, z):
        b = jnp.asarray(self.b, dtype=z.dtype)
        z_masked = b * z
        scale, trans = self._maps(params, z_masked)
        z_ = z_masked + (1 - b) * (z * jnp.exp(scale) + trans)
        log_det = jnp.sum((1 - b) * scale, axis=-1)
        return z_, log_det

    def inverse(self, params, z):
        b = jnp.asarray(self.b, dtype=z.dtype)
        z_masked = b * z
        scale, trans = self._maps(params, z_masked)
        z_ = z_masked + (1 - b) * (z - trans) * jnp.exp(-scale)
        log_det = -jnp.sum((1 - b) * scale, axis=-1)
        return z_, log_det


@dataclasses.dataclass(frozen=True)
class AffineCouplingBlock:
    """Split -> AffineCoupling -> Merge on channel halves; ref ``coupling.py:235-267``."""

    param_map: Any
    scale: bool = True
    scale_map: str = "exp"

    def _coupling(self):
        return AffineCoupling(self.param_map, self.scale, self.scale_map)

    def init_params(self, key: jax.Array):
        return self._coupling().init_params(key)

    def forward(self, params, z):
        d = z.shape[-1]
        z1, z2 = z[:, : d // 2], z[:, d // 2:]
        (z1, z2), log_det = self._coupling().forward(params, (z1, z2))
        return jnp.concatenate([z1, z2], axis=-1), log_det

    def inverse(self, params, z):
        d = z.shape[-1]
        z1, z2 = z[:, : d // 2], z[:, d // 2:]
        (z1, z2), log_det = self._coupling().inverse(params, (z1, z2))
        return jnp.concatenate([z1, z2], axis=-1), log_det
