"""Image-flow components: ConvNet2d, NCHW affine coupling, GlowBlock.

Equivalents of the reference's image stack:

* ``ConvNet2d``   — ``nets/cnn.py:5-63``: conv stack with LeakyReLU and a
  zero-initialized final conv.
* ``ActNormImage``— per-channel ActNorm over NCHW (``flows/affine/glow.py:71``
  uses ``ActNorm((C, 1, 1))``).
* ``GlowBlock``   — ``flows/affine/glow.py:11-84``: channel-split affine
  coupling (sigmoid scale map) + invertible 1x1 conv + ActNorm.

Convs run via ``lax.conv_general_dilated`` in NCHW with fp32 accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.mixing import Invertible1x1Conv


def _conv_init(key, in_c, out_c, k, zeros=False):
    if zeros:
        return {"w": jnp.zeros((out_c, in_c, k, k)),
                "b": jnp.zeros((out_c,))}
    fan_in = in_c * k * k
    bound = 1.0 / np.sqrt(fan_in)
    kw, kb = jax.random.split(key)
    return {"w": jax.random.uniform(kw, (out_c, in_c, k, k), minval=-bound,
                                    maxval=bound),
            "b": jax.random.uniform(kb, (out_c,), minval=-bound,
                                    maxval=bound)}


def _conv(params, x, k):
    pad = k // 2
    out = jax.lax.conv_general_dilated(
        x, params["w"], window_strides=(1, 1),
        padding=[(pad, pad), (pad, pad)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32)
    return out + params["b"][None, :, None, None]


@dataclasses.dataclass(frozen=True)
class ConvNet2d:
    """Conv stack; ref ``nets/cnn.py:5-63``.

    channels: (in, hidden..., out); kernel_size per layer (odd).
    """

    channels: Tuple[int, ...]
    kernel_size: Tuple[int, ...] = (3, 1, 3)
    leaky: float = 0.0
    init_zeros: bool = True

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.channels) - 1)
        return [
            _conv_init(k, self.channels[i], self.channels[i + 1],
                       self.kernel_size[i],
                       zeros=(self.init_zeros and i == len(keys) - 1))
            for i, k in enumerate(keys)
        ]

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        for i, p in enumerate(params):
            x = _conv(p, x, self.kernel_size[i])
            if i < len(params) - 1:
                x = jnp.where(x >= 0, x, self.leaky * x)
        return x


@dataclasses.dataclass(frozen=True)
class ConvResidualNet:
    """Pre-activation conv residual net; ref ``nets/resnet.py:107-209``.

    1x1 initial conv → ``num_blocks`` residual blocks of two 3x3 convs with
    pre-activation (second conv init U(-1e-3, 1e-3), the reference's
    zero_initialization ``resnet.py:137-139``) → 1x1 final conv.  The
    reference's context conv/GLU, dropout, and BatchNorm are omitted: no
    caller in the reference passes context, and dropout/BatchNorm carry
    train-eval statefulness the functional design avoids (same deviation as
    :class:`flowstate.flows.nets.ResidualNet`).
    """

    in_channels: int
    out_channels: int
    hidden_channels: int
    num_blocks: int = 2

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, 2 + 2 * self.num_blocks)
        params = {"initial": _conv_init(keys[0], self.in_channels,
                                        self.hidden_channels, 1)}
        blocks = []
        for b in range(self.num_blocks):
            c1 = _conv_init(keys[1 + 2 * b], self.hidden_channels,
                            self.hidden_channels, 3)
            k1, k2 = jax.random.split(keys[2 + 2 * b])
            c2 = {"w": jax.random.uniform(
                      k1, (self.hidden_channels, self.hidden_channels, 3, 3),
                      minval=-1e-3, maxval=1e-3),
                  "b": jax.random.uniform(
                      k2, (self.hidden_channels,), minval=-1e-3, maxval=1e-3)}
            blocks.append({"c1": c1, "c2": c2})
        params["blocks"] = blocks
        params["final"] = _conv_init(keys[-1], self.hidden_channels,
                                     self.out_channels, 1)
        return params

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        t = _conv(params["initial"], x, 1)
        for blk in params["blocks"]:
            r = jax.nn.relu(t)
            r = _conv(blk["c1"], r, 3)
            r = jax.nn.relu(r)
            r = _conv(blk["c2"], r, 3)
            t = t + r
        return _conv(params["final"], t, 1)


@dataclasses.dataclass(frozen=True)
class ActNormImage:
    """Per-channel affine const flow on NCHW; data-dependent init."""

    num_channels: int

    def init_params(self, key: jax.Array):
        return {"s": jnp.zeros((self.num_channels,)),
                "t": jnp.zeros((self.num_channels,))}

    def init_params_from_data(self, z: jnp.ndarray):
        std = jnp.std(z, axis=(0, 2, 3))
        s = -jnp.log(std + 1e-6)
        t = -jnp.mean(z, axis=(0, 2, 3)) * jnp.exp(s)
        return {"s": s, "t": t}

    def forward(self, params, z):
        s = params["s"][None, :, None, None]
        t = params["t"][None, :, None, None]
        z_ = z * jnp.exp(s) + t
        hw = z.shape[2] * z.shape[3]
        log_det = jnp.broadcast_to(hw * jnp.sum(params["s"]), (z.shape[0],))
        return z_, log_det

    def inverse(self, params, z):
        s = params["s"][None, :, None, None]
        t = params["t"][None, :, None, None]
        z_ = (z - t) * jnp.exp(-s)
        hw = z.shape[2] * z.shape[3]
        log_det = jnp.broadcast_to(-hw * jnp.sum(params["s"]), (z.shape[0],))
        return z_, log_det


@dataclasses.dataclass(frozen=True)
class GlowBlock:
    """One Glow block on NCHW images; ref ``flows/affine/glow.py:11-84``."""

    channels: int
    hidden_channels: int
    scale: bool = True
    scale_map: str = "sigmoid"
    use_lu: bool = True
    leaky: float = 0.0

    def _net(self) -> ConvNet2d:
        num_param = 2 if self.scale else 1
        c1 = (self.channels + 1) // 2
        c2 = self.channels // 2
        return ConvNet2d(
            channels=(c1, self.hidden_channels, self.hidden_channels,
                      num_param * c2),
            kernel_size=(3, 1, 3), leaky=self.leaky, init_zeros=True)

    def _conv1x1(self) -> Invertible1x1Conv:
        return Invertible1x1Conv(self.channels, use_lu=self.use_lu)

    def _actnorm(self) -> ActNormImage:
        return ActNormImage(self.channels)

    def init_params(self, key: jax.Array):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"net": self._net().init_params(k1),
                "conv1x1": self._conv1x1().init_params(k2),
                "actnorm": self._actnorm().init_params(k3)}

    def _coupling(self, params, z, inverse: bool):
        c1 = (self.channels + 1) // 2
        z1, z2 = z[:, :c1], z[:, c1:]
        raw = self._net().apply(params["net"], z1)
        if self.scale:
            shift = raw[:, 0::2]
            scale_raw = raw[:, 1::2]
            if self.scale_map == "sigmoid":
                s = jax.nn.sigmoid(scale_raw + 2.0)
                if inverse:
                    z2 = (z2 - shift) * s
                    ld = jnp.sum(jnp.log(s), axis=(1, 2, 3))
                else:
                    z2 = z2 / s + shift
                    ld = -jnp.sum(jnp.log(s), axis=(1, 2, 3))
            else:  # exp
                if inverse:
                    z2 = (z2 - shift) * jnp.exp(-scale_raw)
                    ld = -jnp.sum(scale_raw, axis=(1, 2, 3))
                else:
                    z2 = z2 * jnp.exp(scale_raw) + shift
                    ld = jnp.sum(scale_raw, axis=(1, 2, 3))
        else:
            z2 = z2 - raw if inverse else z2 + raw
            ld = jnp.zeros(z.shape[0], dtype=z.dtype)
        return jnp.concatenate([z1, z2], axis=1), ld

    def forward(self, params, z):
        z, ld = self._coupling(params, z, inverse=False)
        log_det = ld
        if self.channels > 1:
            z, ld = self._conv1x1().forward(params["conv1x1"], z)
            log_det = log_det + ld
        z, ld = self._actnorm().forward(params["actnorm"], z)
        return z, log_det + ld

    def inverse(self, params, z):
        z, ld = self._actnorm().inverse(params["actnorm"], z)
        log_det = ld
        if self.channels > 1:
            z, ld2 = self._conv1x1().inverse(params["conv1x1"], z)
            log_det = log_det + ld2
        z, ld3 = self._coupling(params, z, inverse=True)
        return z, log_det + ld3
