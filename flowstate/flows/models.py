"""Additional flow model classes: conditional, class-conditional, multiscale.

Equivalents of the remaining ``NF/normflows/core.py`` models:

* ``ConditionalNormalizingFlow`` — context passed to every layer
  (``core.py:233-383``); layers must accept ``context`` in
  forward/inverse.
* ``ClassCondFlow``              — class label passed only to the base
  (``core.py:386-469``).
* ``MultiscaleFlow``             — RealNVP/Glow multiscale architecture
  with per-level bases and merge operations (``core.py:472-670``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ContextAffineCoupling:
    """Affine coupling whose parameter net sees [identity_half, context].

    The context-capable layer for :class:`ConditionalNormalizingFlow`.  The
    reference threads context into the coupling's ``ResidualNet`` through a
    GLU gate (``nets/resnet.py:48-49``); here the context simply concatenates
    onto the conditioner input — same information flow, one fused matmul.
    Sigmoid-bounded scale map (``affine/coupling.py`` ``scale_map='sigmoid'``
    semantics) for unconditional stability.
    """

    features: int
    context_features: int
    hidden_features: int = 64
    flip: bool = False  # transform the other half (alternate between layers)

    def _split(self, z):
        half = self.features // 2
        if self.flip:
            return z[:, half:], z[:, :half], half
        return z[:, :half], z[:, half:], half

    def _join(self, ident, trans):
        if self.flip:
            return jnp.concatenate([trans, ident], axis=-1)
        return jnp.concatenate([ident, trans], axis=-1)

    def _net(self):
        from flowstate.flows.nets import MLP

        half = self.features // 2
        out = 2 * (self.features - half)
        return MLP((half + self.context_features, self.hidden_features,
                    self.hidden_features, out), init_zeros=True)

    def init_params(self, key: jax.Array):
        return {"net": self._net().init_params(key)}

    def _shift_log_scale(self, params, ident, context):
        raw = self._net().apply(params["net"],
                                jnp.concatenate([ident, context], axis=-1))
        shift, s = jnp.split(raw, 2, axis=-1)
        log_scale = jnp.log(jax.nn.sigmoid(s + 2.0) + 1e-3)
        return shift, log_scale

    def forward(self, params, z, context=None):
        ident, trans, _ = self._split(z)
        shift, log_scale = self._shift_log_scale(params, ident, context)
        trans = trans * jnp.exp(log_scale) + shift
        return self._join(ident, trans), jnp.sum(log_scale, axis=-1)

    def inverse(self, params, x, context=None):
        ident, trans, _ = self._split(x)
        shift, log_scale = self._shift_log_scale(params, ident, context)
        trans = (trans - shift) * jnp.exp(-log_scale)
        return self._join(ident, trans), -jnp.sum(log_scale, axis=-1)


@dataclasses.dataclass(frozen=True)
class ConditionalNormalizingFlow:
    """Flow whose layers and base take a context vector; ref core.py:233-383.

    The base may be context-free (e.g. ``UniformParticle`` — the blocked
    proposal's case, ``mcmc/blocked.py``): base calls fall back to the
    context-less signature when the base does not accept one.
    """

    base: Any
    layers: Tuple[Any, ...]

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.layers))
        return tuple(l.init_params(k) for l, k in zip(self.layers, keys))

    def _base_log_prob(self, z, context):
        try:
            return self.base.log_prob(z, context)
        except TypeError:
            return self.base.log_prob(z)

    def _base_sample(self, key, num_samples, context):
        try:
            return self.base.sample(key, num_samples, context)
        except TypeError:
            return self.base.sample(key, num_samples)

    def forward_and_log_det(self, params, z, context=None):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        for layer, p in zip(self.layers, params):
            z, ld = layer.forward(p, z, context=context)
            log_det = log_det + ld
        return z, log_det

    def inverse_and_log_det(self, params, x, context=None):
        log_det = jnp.zeros(x.shape[0], dtype=x.dtype)
        for layer, p in zip(reversed(self.layers), reversed(params)):
            x, ld = layer.inverse(p, x, context=context)
            log_det = log_det + ld
        return x, log_det

    def log_prob(self, params, x, context=None):
        z, log_q = self.inverse_and_log_det(params, x, context)
        return log_q + self._base_log_prob(z, context)

    def forward_kld(self, params, x, context=None):
        return -jnp.mean(self.log_prob(params, x, context))

    def sample(self, params, key, num_samples, context=None):
        z = self._base_sample(key, num_samples, context)
        x, _ = self.forward_and_log_det(params, z, context)
        return x

    def sample_and_log_prob(self, params, key, num_samples, context=None):
        """Samples plus their log q(x | context) in one forward pass
        (the fused form ``NormalizingFlow.sample_and_log_prob`` uses for
        big moves — one flow sweep instead of sample + log_prob)."""
        z = self._base_sample(key, num_samples, context)
        log_q = self._base_log_prob(z, context)
        x, log_det = self.forward_and_log_det(params, z, context)
        return x, log_q - log_det

    def sample_and_log_prob_with_old(self, params, key, num_samples,
                                     x_old, context=None):
        """``(x_new, log_q_new, log_q_old)`` in one lockstep pass.

        The blocked proposal's MH ratio (``mcmc/blocked.py``) needs
        q(new | ctx) (forward sweep) and q(old | ctx) (inverse sweep);
        when the stack is a single ``ScannedLayers`` both run in ONE
        K-step scan with batched per-step conditioners
        (``ScannedLayers.paired_forward_inverse`` — halves the serial
        coupling-chain depth — the move's dominant cost; +10% measured).
        Falls back to the separate passes otherwise.
        """
        from flowstate.flows.core import _supports_paired

        z = self._base_sample(key, num_samples, context)
        lq0 = self._base_log_prob(z, context)
        if _supports_paired(self.layers):
            (x_new, ld_f), (z_old, ld_i) = (
                self.layers[0].paired_forward_inverse(
                    params[0], z, x_old, context=context))
            return (x_new, lq0 - ld_f,
                    ld_i + self._base_log_prob(z_old, context))
        x_new, ld_f = self.forward_and_log_det(params, z, context)
        return x_new, lq0 - ld_f, self.log_prob(params, x_old, context)

    # persistence (same pickle-the-pytree convention as NormalizingFlow,
    # reference core.py:216-230)
    def save(self, params, path: str) -> None:
        import pickle
        with open(path, "wb") as f:
            pickle.dump(jax.device_get(params), f)

    def load(self, path: str):
        import pickle
        with open(path, "rb") as f:
            return jax.tree_util.tree_map(jnp.asarray, pickle.load(f))


@dataclasses.dataclass(frozen=True)
class ClassCondFlow:
    """Class label conditions only the base; ref core.py:386-469."""

    base: Any   # log_prob(z, y), sample(key, n, y)
    layers: Tuple[Any, ...]

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.layers))
        return tuple(l.init_params(k) for l, k in zip(self.layers, keys))

    def log_prob(self, params, x, y):
        log_q = jnp.zeros(x.shape[0], dtype=x.dtype)
        z = x
        for layer, p in zip(reversed(self.layers), reversed(params)):
            z, ld = layer.inverse(p, z)
            log_q = log_q + ld
        return log_q + self.base.log_prob(z, y)

    def forward_kld(self, params, x, y):
        return -jnp.mean(self.log_prob(params, x, y))

    def sample(self, params, key, num_samples, y):
        z = self.base.sample(key, num_samples, y)
        for layer, p in zip(self.layers, params):
            z, _ = layer.forward(p, z)
        return z


@dataclasses.dataclass(frozen=True)
class MultiscaleFlow:
    """Multiscale (RealNVP/Glow) architecture; ref core.py:472-670.

    bases: per-level base distributions (level 0 is the deepest).
    flows: per-level tuples of flow layers.
    merges: level-joining Merge operations (forward does merge).
    transform: optional initial data transform (e.g. Logit flow layer).
    """

    bases: Tuple[Any, ...]
    flows: Tuple[Tuple[Any, ...], ...]
    merges: Tuple[Any, ...]
    transform: Optional[Any] = None

    def init_params(self, key: jax.Array):
        n_flows = sum(len(f) for f in self.flows)
        keys = jax.random.split(key, n_flows + 2)
        ki = iter(keys)
        flow_params = tuple(
            tuple(layer.init_params(next(ki)) for layer in level)
            for level in self.flows)
        transform_params = (self.transform.init_params(next(ki))
                            if self.transform is not None else None)
        return {"flows": flow_params, "transform": transform_params}

    def forward_and_log_det(self, params, z_list: Sequence[jnp.ndarray]):
        """Latents per level -> observed x; ref core.py:560-585."""
        log_det = jnp.zeros(z_list[0].shape[0], dtype=z_list[0].dtype)
        z_ = z_list[0]
        for i in range(len(self.bases)):
            if i > 0:
                z_, ld = self.merges[i - 1].forward({}, [z_, z_list[i]])
                log_det = log_det + ld
            for layer, p in zip(self.flows[i], params["flows"][i]):
                z_, ld = layer.forward(p, z_)
                log_det = log_det + ld
        if self.transform is not None:
            z_, ld = self.transform.forward(params["transform"], z_)
            log_det = log_det + ld
        return z_, log_det

    def inverse_and_log_det(self, params, x):
        """Observed x -> per-level latents; ref core.py:587-612."""
        log_det = jnp.zeros(x.shape[0], dtype=x.dtype)
        if self.transform is not None:
            x, ld = self.transform.inverse(params["transform"], x)
            log_det = log_det + ld
        z_list = []
        z_ = x
        for i in range(len(self.bases) - 1, -1, -1):
            for layer, p in zip(reversed(self.flows[i]),
                                reversed(params["flows"][i])):
                z_, ld = layer.inverse(p, z_)
                log_det = log_det + ld
            if i > 0:
                (z_, z_level), ld = self.merges[i - 1].inverse({}, z_)
                log_det = log_det + ld
                z_list.append(z_level)
        z_list.append(z_)
        return list(reversed(z_list)), log_det

    def log_prob(self, params, x, y=None):
        z_list, log_q = self.inverse_and_log_det(params, x)
        for base, z in zip(self.bases, z_list):
            if y is not None:
                log_q = log_q + base.log_prob(z, y)
            else:
                log_q = log_q + base.log_prob(z)
        return log_q

    def forward_kld(self, params, x, y=None):
        return -jnp.mean(self.log_prob(params, x, y))

    def sample(self, params, key, num_samples, y=None):
        keys = jax.random.split(key, len(self.bases))
        z_list = []
        for base, k in zip(self.bases, keys):
            if y is not None:
                z_list.append(base.sample(k, num_samples, y))
            else:
                z_list.append(base.sample(k, num_samples))
        x, _ = self.forward_and_log_det(params, z_list)
        return x
