"""Latent reshaping flows: Split / Merge / Squeeze.

Equivalents of ``NF/normflows/flows/reshape.py``:

* ``Split``   — split features into two sets: channel halves (optionally
  flipped) or checkerboard coloring (``reshape.py:9-87``)
* ``Merge``   — Split with forward/inverse swapped (``reshape.py:90-101``)
* ``Squeeze`` — multi-scale 2x2 space-to-channel squeeze for NCHW images
  (``reshape.py:104-128``)

All are volume-preserving (log-det 0).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _checkerboard(shape, inv: bool) -> np.ndarray:
    """0/1 coloring over the non-batch dims (reference reshape.py:36-46)."""
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    parity = sum(grids) % 2
    cb = (parity == 0).astype(np.int8)
    return 1 - cb if inv else cb


@dataclasses.dataclass(frozen=True)
class Split:
    mode: str = "channel"

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        if self.mode == "channel":
            z1, z2 = jnp.split(z, 2, axis=1)
        elif self.mode == "channel_inv":
            z2, z1 = jnp.split(z, 2, axis=1)
        elif "checkerboard" in self.mode:
            cb = _checkerboard(z.shape[1:], "inv" in self.mode)
            flat = z.reshape(z.shape[0], -1)
            cb_flat = cb.reshape(-1).astype(bool)
            z1 = flat[:, cb_flat].reshape(*z.shape[:-1], -1)
            z2 = flat[:, ~cb_flat].reshape(*z.shape[:-1], -1)
        else:
            raise NotImplementedError(f"Mode {self.mode} is not implemented.")
        return [z1, z2], jnp.zeros(z.shape[0] if hasattr(z, "shape") else 1)

    def inverse(self, params, z):
        z1, z2 = z
        if self.mode == "channel":
            out = jnp.concatenate([z1, z2], axis=1)
        elif self.mode == "channel_inv":
            out = jnp.concatenate([z2, z1], axis=1)
        elif "checkerboard" in self.mode:
            out_shape = list(z1.shape)
            out_shape[-1] *= 2
            cb = _checkerboard(out_shape[1:], "inv" in self.mode)
            cb_flat = cb.reshape(-1).astype(bool)
            flat = jnp.zeros((z1.shape[0], int(np.prod(out_shape[1:]))),
                             dtype=z1.dtype)
            flat = flat.at[:, cb_flat].set(z1.reshape(z1.shape[0], -1))
            flat = flat.at[:, ~cb_flat].set(z2.reshape(z2.shape[0], -1))
            out = flat.reshape(out_shape)
        else:
            raise NotImplementedError(f"Mode {self.mode} is not implemented.")
        return out, jnp.zeros(out.shape[0], dtype=out.dtype)


@dataclasses.dataclass(frozen=True)
class Merge(Split):
    """Split with forward/inverse interchanged; ref ``reshape.py:90-101``."""

    def forward(self, params, z):
        return Split.inverse(self, params, z)

    def inverse(self, params, z):
        return Split.forward(self, params, z)


@dataclasses.dataclass(frozen=True)
class Squeeze:
    """2x2 space-to-channel squeeze (NCHW); ref ``reshape.py:104-128``.

    Note the reference convention: ``forward`` UN-squeezes (C/4, 2H, 2W)
    and ``inverse`` squeezes (4C, H/2, W/2) — matched here.
    """

    def init_params(self, key: jax.Array):
        return {}

    def forward(self, params, z):
        b, c, h, w = z.shape
        z = z.reshape(b, c // 4, 2, 2, h, w)
        z = z.transpose(0, 1, 4, 2, 5, 3)
        z = z.reshape(b, c // 4, 2 * h, 2 * w)
        return z, jnp.zeros(b, dtype=z.dtype)

    def inverse(self, params, z):
        b, c, h, w = z.shape
        z = z.reshape(b, c, h // 2, 2, w // 2, 2)
        z = z.transpose(0, 1, 3, 5, 2, 4)
        z = z.reshape(b, 4 * c, h // 2, w // 2)
        return z, jnp.zeros(b, dtype=z.dtype)
