"""Parameter networks for coupling layers (pure functional, pytree params).

Equivalents of the reference's param-net backends:

* ``ResidualNet``      — pre-activation MLP residual net
  (``NF/normflows/nets/resnet.py:7-104``).  The reference's circular wrapper
  enables BatchNorm (``wrapper.py:177``), which is hostile to the jit/vmap
  train-eval duality; we use LayerNorm instead (documented deviation, cf.
  SURVEY.md §7.3 — upstream normflows defaults to no norm at all and the
  flow trains fine either way).
* ``MLP``              — ``NF/normflows/nets/mlp.py:5-58``.
* ``TransformerNet``   — self-attention param net
  (``NF/normflows/nets/Transformer.py:4-68``): linear embed → N pre-norm
  self-attention blocks → linear out, no positional encoding.
* ``TorusEGNN``        — E(n)-equivariant message passing on the torus
  (``NF/normflows/nets/graph_network.py:8-159``): 2π-wrapped relative
  coordinates, stacked message-passing layers, mean-pool readout.

Every net is a (init_fn, apply_fn) pair; the hidden sizes are static config.
Matmuls are emitted with ``preferred_element_type=float32`` so XLA keeps
accumulation in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Activation = Callable[[jnp.ndarray], jnp.ndarray]


def _linear_init(key, in_dim, out_dim):
    """Torch nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in)) for W and b."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / np.sqrt(in_dim)
    w = jax.random.uniform(kw, (in_dim, out_dim), minval=-bound, maxval=bound)
    b = jax.random.uniform(kb, (out_dim,), minval=-bound, maxval=bound)
    return {"w": w, "b": b}


def _linear(params, x, compute_dtype=None):
    # fp32 accumulation by default; honor fp64 when the x64 parity
    # tests run with double inputs (downcasting there would cap parity
    # at fp32 noise).  ``compute_dtype='bfloat16'`` runs the matmul with
    # bf16 operands AND bf16 output (params stay fp32 in the pytree; the
    # matmul still accumulates in fp32 internally) — halving the bytes
    # of every weight read and every saved activation.
    if compute_dtype is not None:
        cd = jnp.dtype(compute_dtype)
        return (jnp.dot(x.astype(cd), params["w"].astype(cd))
                + params["b"].astype(cd))
    pet = (jnp.float64 if jnp.promote_types(x.dtype, params["w"].dtype)
           == jnp.float64 else jnp.float32)
    return jnp.dot(x, params["w"], preferred_element_type=pet) + params["b"]


def _layer_norm(x, eps=1e-3):
    # statistics in fp32 even under a bf16 compute dtype (bf16 variance is
    # too coarse); the normalized output keeps x's dtype
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    return ((xf - mean) * jax.lax.rsqrt(var + eps)).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class ResidualNet:
    """Pre-activation residual MLP; reference ``nets/resnet.py:53-104``.

    ``use_norm`` replaces the reference's BatchNorm (``resnet.py:22-26``)
    with stateless LayerNorm.  ``context_features`` enables the reference's
    conditional path: the context concatenates into the initial layer
    (``resnet.py:72-77, 98-100``) and gates every residual block through a
    GLU (``resnet.py:27-28, 48-49``: ``glu(cat(h, W_c c)) = h * sigmoid(W_c
    c)``).  ``dropout_probability`` matches ``resnet.py:32, 46`` — applied
    between the block's activations only when ``apply`` is given a ``key``
    (pure-functional train/eval split: no key, no dropout).
    """

    in_features: int
    out_features: int
    hidden_features: int
    num_blocks: int = 2
    use_norm: bool = False
    activation: Activation = jax.nn.relu
    preprocessing: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None
    context_features: Optional[int] = None
    dropout_probability: float = 0.0
    # 'bfloat16' runs every matmul + hidden activation in bf16 (params and
    # the returned output stay fp32).  A bytes lever: the net's weight
    # reads + saved activations are most of the flow passes' bytes.  For MCMC proposals this is
    # EXACT (the spline parameters the net emits define the proposal q, and
    # log q is computed from those same parameters — MH corrects any q).
    compute_dtype: Optional[str] = None

    def init_params(self, key: jax.Array, init_identity: bool = False,
                    identity_bias: float = 0.0):
        ctx = self.context_features
        # key layout is unchanged when ctx is None (keeps every existing
        # seeded initialization bit-identical); ctx keys append at the end
        keys = jax.random.split(
            key, (3 + 3 * self.num_blocks) if ctx
            else (2 + 2 * self.num_blocks))
        params = {"initial": _linear_init(
            keys[0], self.in_features + (ctx or 0), self.hidden_features)}
        blocks = []
        for b in range(self.num_blocks):
            l1 = _linear_init(keys[1 + 2 * b], self.hidden_features,
                              self.hidden_features)
            l2 = _linear_init(keys[2 + 2 * b], self.hidden_features,
                              self.hidden_features)
            # zero_initialization of the block's last layer
            # (reference resnet.py:33-35): U(-1e-3, 1e-3)
            k1, k2 = jax.random.split(keys[2 + 2 * b])
            l2 = {"w": jax.random.uniform(
                      k1, l2["w"].shape, minval=-1e-3, maxval=1e-3),
                  "b": jax.random.uniform(
                      k2, l2["b"].shape, minval=-1e-3, maxval=1e-3)}
            block = {"l1": l1, "l2": l2}
            if ctx:
                block["ctx"] = _linear_init(
                    keys[2 + 2 * self.num_blocks + b], ctx,
                    self.hidden_features)
            blocks.append(block)
        params["blocks"] = blocks
        final = _linear_init(keys[-1], self.hidden_features, self.out_features)
        if init_identity:
            # reference wrapper.py:181-185: final W = 0, b = softplus^-1(1-md)
            final = {"w": jnp.zeros_like(final["w"]),
                     "b": jnp.full_like(final["b"], identity_bias)}
        params["final"] = final
        return params

    def apply(self, params, x: jnp.ndarray, context: jnp.ndarray = None,
              key: jax.Array = None) -> jnp.ndarray:
        cd = self.compute_dtype
        out_dtype = x.dtype
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        if self.context_features:
            x = jnp.concatenate([x, context], axis=-1)
        if cd is not None:
            x = x.astype(cd)
            if context is not None:
                context = context.astype(cd)
        t = _linear(params["initial"], x, cd)
        for i, blk in enumerate(params["blocks"]):
            r = t
            if self.use_norm:
                r = _layer_norm(r)
            r = self.activation(r)
            r = _linear(blk["l1"], r, cd)
            if self.use_norm:
                r = _layer_norm(r)
            r = self.activation(r)
            if self.dropout_probability > 0.0 and key is not None:
                keep = 1.0 - self.dropout_probability
                mask = jax.random.bernoulli(
                    jax.random.fold_in(key, i), keep, r.shape)
                r = jnp.where(mask, r / keep, 0.0)
            r = _linear(blk["l2"], r, cd)
            if self.context_features:
                # GLU gate (resnet.py:48-49)
                r = r * jax.nn.sigmoid(_linear(blk["ctx"], context, cd))
            t = t + r
        out = _linear(params["final"], t, cd)
        return out.astype(out_dtype) if cd is not None else out


@dataclasses.dataclass(frozen=True)
class MLP:
    """Plain MLP; reference ``nets/mlp.py:5-58``."""

    layers: tuple  # (in, h1, ..., out)
    activation: Activation = jax.nn.relu
    init_zeros: bool = False

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.layers) - 1)
        params = [_linear_init(k, self.layers[i], self.layers[i + 1])
                  for i, k in enumerate(keys)]
        if self.init_zeros:
            params[-1] = {"w": jnp.zeros_like(params[-1]["w"]),
                          "b": jnp.zeros_like(params[-1]["b"])}
        return params

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        for p in params[:-1]:
            x = self.activation(_linear(p, x))
        return _linear(params[-1], x)


@dataclasses.dataclass(frozen=True)
class TransformerNet:
    """Self-attention param net; reference ``nets/Transformer.py:34-68``.

    Embeds the (featurized) input vector as a length-D sequence of scalars,
    runs ``num_layers`` attention blocks, projects back.  No positional
    encoding, as in the reference.
    """

    in_features: int
    out_features: int
    embed_dim: int = 64
    num_heads: int = 4
    num_layers: int = 2
    preprocessing: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None

    def init_params(self, key: jax.Array, init_identity: bool = False,
                    identity_bias: float = 0.0):
        keys = jax.random.split(key, 2 + 4 * self.num_layers)
        e = self.embed_dim
        params = {"embed": _linear_init(keys[0], 1, e), "blocks": []}
        for i in range(self.num_layers):
            k0, k1, k2, k3 = jax.random.split(keys[1 + i], 4)
            params["blocks"].append({
                "qkv": _linear_init(k0, e, 3 * e),
                "proj": _linear_init(k1, e, e),
                "ff1": _linear_init(k2, e, 4 * e),
                "ff2": _linear_init(k3, 4 * e, e),
            })
        final = _linear_init(keys[-1], self.in_features * e, self.out_features)
        if init_identity:
            final = {"w": jnp.zeros_like(final["w"]),
                     "b": jnp.full_like(final["b"], identity_bias)}
        params["final"] = final
        return params

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        b, d = x.shape
        e, h = self.embed_dim, self.num_heads
        t = _linear(params["embed"], x[..., None])  # (B, D, E)
        for blk in params["blocks"]:
            qkv = _linear(blk["qkv"], _layer_norm(t))  # (B, D, 3E)
            q, k, v = jnp.split(qkv, 3, axis=-1)
            q = q.reshape(b, d, h, e // h)
            k = k.reshape(b, d, h, e // h)
            v = v.reshape(b, d, h, e // h)
            att = jnp.einsum("bqhc,bkhc->bhqk", q, k,
                             preferred_element_type=jnp.float32)
            att = jax.nn.softmax(att / np.sqrt(e // h), axis=-1)
            o = jnp.einsum("bhqk,bkhc->bqhc", att, v,
                           preferred_element_type=jnp.float32)
            t = t + _linear(blk["proj"], o.reshape(b, d, e))
            ff = _linear(blk["ff2"], jax.nn.gelu(
                _linear(blk["ff1"], _layer_norm(t))))
            t = t + ff
        return _linear(params["final"], t.reshape(b, d * e))


@dataclasses.dataclass(frozen=True)
class TorusEGNN:
    """Equivariant message-passing param net on the torus.

    Reference ``nets/graph_network.py:8-159`` (``TorusEGNN`` +
    ``FullEquivariantGraphNetwork``): messages built from 2π-wrapped relative
    coordinates between particle nodes, mean-pool readout to spline params.
    """

    num_node: int        # number of input features (treated as N*d coords)
    out_dim: int
    feat_dim: int = 2    # coordinates per particle
    hidden_dim: int = 64
    num_layers: int = 2
    preprocessing: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None

    @property
    def n_particles(self) -> int:
        return max(1, self.num_node // self.feat_dim)

    def init_params(self, key: jax.Array, init_identity: bool = False,
                    identity_bias: float = 0.0):
        keys = jax.random.split(key, 3 * self.num_layers + 2)
        h = self.hidden_dim
        params = {"embed": _linear_init(keys[0], 2 * self.feat_dim, h),
                  "layers": []}
        for i in range(self.num_layers):
            k0, k1, k2 = jax.random.split(keys[1 + i], 3)
            params["layers"].append({
                "msg": _linear_init(k0, 2 * h + 2 * self.feat_dim, h),
                "upd": _linear_init(k1, 2 * h, h),
            })
        final = _linear_init(keys[-1], h, self.out_dim)
        if init_identity:
            final = {"w": jnp.zeros_like(final["w"]),
                     "b": jnp.full_like(final["b"], identity_bias)}
        params["final"] = final
        return params

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        # x: (B, num_node) flattened coordinates; preprocessing (the
        # pi/tail_bound radian scaling from the coupling wrapper) maps them
        # onto the 2*pi torus the wrap below assumes.
        if self.preprocessing is not None:
            x = self.preprocessing(x)
        b = x.shape[0]
        n, fd = self.n_particles, self.feat_dim
        coords = x[:, : n * fd].reshape(b, n, fd)
        # angle featurization of node coords (torus embedding)
        hfeat = jnp.concatenate([jnp.cos(coords), jnp.sin(coords)], axis=-1)
        h = _linear(params["embed"], hfeat)  # (B, N, H)
        for layer in params["layers"]:
            rel = coords[:, :, None, :] - coords[:, None, :, :]
            # 2π wrap of relative coordinates (graph_network.py:67-68)
            rel = rel - 2 * jnp.pi * jnp.round(rel / (2 * jnp.pi))
            rel_feat = jnp.concatenate([jnp.sin(rel), jnp.cos(rel)], axis=-1)
            hi = jnp.broadcast_to(h[:, :, None, :], (b, n, n, h.shape[-1]))
            hj = jnp.broadcast_to(h[:, None, :, :], (b, n, n, h.shape[-1]))
            m_in = jnp.concatenate([hi, hj, rel_feat], axis=-1)
            m = jax.nn.silu(_linear(layer["msg"], m_in))
            mask = 1.0 - jnp.eye(n)[None, :, :, None]
            agg = jnp.sum(m * mask, axis=2)
            h = h + jax.nn.silu(_linear(
                layer["upd"], jnp.concatenate([h, agg], axis=-1)))
        pooled = jnp.mean(h, axis=1)  # (B, H) mean-pool readout
        return _linear(params["final"], pooled)


@dataclasses.dataclass(frozen=True)
class ConstScaleLayer:
    """Fixed-factor feature scaling; ref ``utils/nn.py:7-23``."""

    scale: float = 1.0

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return x * self.scale


def clamp_exp(x: jnp.ndarray) -> jnp.ndarray:
    """Nonlinearity min(exp(x), 1); ref ``utils/nn.py:46-61`` (``ClampExp``)."""
    return jnp.minimum(jnp.exp(x), 1.0)


ClampExp = clamp_exp  # reference class name alias


@dataclasses.dataclass(frozen=True)
class PeriodicFeaturesElementwise:
    """Standalone cos/sin featurizer; ref ``utils/nn.py:64-137`` (fork form:
    the whole input maps to [cos(s x), sin(s x)], doubling the width)."""

    ndim: int
    scale: float = 1.0

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.concatenate([jnp.cos(self.scale * x),
                                jnp.sin(self.scale * x)], axis=-1)


@dataclasses.dataclass(frozen=True)
class PeriodicFeaturesCat:
    """Replace selected dims with [sin(s x), cos(s x)] pairs (concatenated
    ahead of the untouched dims); ref ``utils/nn.py:140-184``."""

    ndim: int
    ind: Tuple[int, ...]
    scale: float = 1.0

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        idx = np.asarray(self.ind)
        rest = np.asarray([i for i in range(self.ndim)
                           if i not in set(self.ind)], dtype=np.int64)
        per = x[..., idx] * self.scale
        feats = jnp.concatenate([jnp.sin(per), jnp.cos(per)], axis=-1)
        if len(rest):
            feats = jnp.concatenate([feats, x[..., rest]], axis=-1)
        return feats
