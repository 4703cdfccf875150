"""Rational-quadratic spline coupling layers (circular + linear tails).

Re-design of the reference stack:

* ``Coupling`` split/recombine + the fixed half-length feature roll between
  couplings — ``NF/normflows/flows/neural_spline/coupling.py:16-134``
  (roll at ``:100-101`` forward / ``:113-114`` inverse, replacing explicit
  permutation layers).
* ``PiecewiseRationalQuadraticCoupling`` — ``coupling.py:268-368``:
  per-dimension tails, transform-dim multiplier, softmax pre-scaling by
  ``1/sqrt(hidden_features)`` (``coupling.py:340-345``).
* ``PiecewiseRationalQuadraticCDF`` (the unconditional trainable spline on
  the identity half) — ``coupling.py:176-265``.
* ``CircularCoupledRationalQuadraticSpline`` wrapper —
  ``flows/neural_spline/wrapper.py:98-275``: alternating binary mask,
  cos/sin periodic featurization with scale π/tail_bound
  (``wrapper.py:151-154`` + ``utils/nn.py:120-137``), selectable param-net
  backend, identity init, and the forward/inverse swap
  (flow.forward = coupling.inverse, ``wrapper.py:269-275``).

Everything is a pure function of (static config, params pytree, batch); no
train/eval mode split exists (LayerNorm replaces the reference's BatchNorm).

Direction convention (matches the reference wrapper):
  ``flow_forward``  : latent -> data   (sampling direction)
  ``flow_inverse``  : data  -> latent  (log_prob direction)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows.nets import ResidualNet, TorusEGNN, TransformerNet
from flowstate.ops.splines import (
    IDENTITY_DERIVATIVE_CONSTANT,
    unconstrained_rational_quadratic_spline,
)


def create_alternating_binary_mask(features: int, even: bool = True) -> np.ndarray:
    """Alternating 0/1 mask; reference ``utils/masks.py:4-17``."""
    mask = np.zeros(features, dtype=np.int8)
    start = 0 if even else 1
    mask[start::2] = 1
    return mask


def create_mid_split_binary_mask(features: int) -> np.ndarray:
    """Mid-split mask; reference ``utils/masks.py:20-31``."""
    mask = np.zeros(features, dtype=np.int8)
    midpoint = features // 2 if features % 2 == 0 else features // 2 + 1
    mask[:midpoint] = 1
    return mask


def create_random_binary_mask(features: int, seed: int = 0) -> np.ndarray:
    """Random half-ones mask; reference ``utils/masks.py:34-56``."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(features, dtype=np.int8)
    num = features // 2 if features % 2 == 0 else features // 2 + 1
    mask[rng.choice(features, size=num, replace=False)] = 1
    return mask


def sum_except_batch(x: jnp.ndarray) -> jnp.ndarray:
    """Reference ``utils/nn.py:197``."""
    return jnp.sum(x.reshape(x.shape[0], -1), axis=-1)


@dataclasses.dataclass(frozen=True)
class CircularSplineCoupling:
    """One circular RQ-spline coupling layer (static config).

    Equivalent to ``CircularCoupledRationalQuadraticSpline``
    (``wrapper.py:98-275``) with ``apply_unconditional_transform=True``.

    Args mirror the reference constructor:
      features:      flow dimension (2N for N particles in 2D)
      num_blocks:    residual blocks of the param net
      hidden_units:  hidden width of the param net
      ind_circ:      indices of circular coordinates (all of them here)
      num_bins:      spline bins
      tail_bound:    half box length (the torus is [-b, b]^D)
      net_type:      'residual' | 'transformer' | 'gnn'
      reverse_mask:  flip the alternating mask
      mask:          optional explicit 0/1 mask (overrides alternating)
    """

    features: int
    num_blocks: int
    hidden_units: int
    ind_circ: Tuple[int, ...]
    num_bins: int = 8
    tail_bound: float = 3.0
    net_type: str = "residual"
    num_heads: int = 4
    reverse_mask: bool = False
    mask: Optional[Tuple[int, ...]] = None
    use_norm: bool = True
    init_identity: bool = True
    # conditional path: context gates the ResidualNet through a GLU
    # (reference coupling.py:51-54 + resnet.py:48-49), making this layer
    # usable inside ConditionalNormalizingFlow (core.py:233-383)
    context_features: Optional[int] = None
    dropout_probability: float = 0.0
    # 'bfloat16': run the param net's matmuls/activations in bf16 (spline
    # math stays fp32).  Exact for MCMC proposals — the emitted spline
    # params define q and log q is computed from the same params — and a
    # bytes-halving lever for the training step (see nets.py).
    compute_dtype: Optional[str] = None
    # True (default) enforces the real boundary-slope tie for circular
    # tails; False reproduces the reference fork's no-op tie (its list-tails
    # path pads a derivative slot the spline never gathers — see
    # ops/splines.py docstring).  Parity tests vs the torch fork set False.
    circular_tie: bool = True

    # ----- static derived structure -------------------------------------

    def _mask_array(self) -> np.ndarray:
        if self.mask is not None:
            return np.asarray(self.mask, dtype=np.int8)
        return create_alternating_binary_mask(self.features,
                                              even=self.reverse_mask)

    @property
    def identity_idx(self) -> np.ndarray:
        return np.where(self._mask_array() <= 0)[0]

    @property
    def transform_idx(self) -> np.ndarray:
        return np.where(self._mask_array() > 0)[0]

    @property
    def _tails_transform(self) -> list:
        circ = set(self.ind_circ)
        return ["circular" if i in circ else "linear"
                for i in self.transform_idx]

    @property
    def _tails_identity(self) -> list:
        circ = set(self.ind_circ)
        return ["circular" if i in circ else "linear"
                for i in self.identity_idx]

    @property
    def _param_multiplier(self) -> int:
        # per-dim tails list -> 3*bins + 1 (coupling.py:327-333, else branch)
        return 3 * self.num_bins + 1

    def _net(self):
        d_id = len(self.identity_idx)
        d_tr = len(self.transform_idx)
        out_features = d_tr * self._param_multiplier
        scale = np.pi / self.tail_bound

        def periodic_features(x):
            # Modified PeriodicFeaturesElementwise (utils/nn.py:120-137):
            # whole input -> [cos(s x), sin(s x)], doubling the width.
            return jnp.concatenate(
                [jnp.cos(scale * x), jnp.sin(scale * x)], axis=-1)

        if self.net_type == "transformer":
            if self.context_features:
                raise ValueError("context is only wired through the "
                                 "residual backend (as in the reference: "
                                 "resnet.py:48-49)")
            return TransformerNet(
                in_features=2 * d_id, out_features=out_features,
                embed_dim=self.hidden_units, num_heads=self.num_heads,
                num_layers=self.num_blocks, preprocessing=periodic_features)
        if self.net_type == "gnn":
            if self.context_features:
                raise ValueError("context is only wired through the "
                                 "residual backend (as in the reference: "
                                 "resnet.py:48-49)")
            return TorusEGNN(
                num_node=d_id, out_dim=out_features, feat_dim=1,
                hidden_dim=self.hidden_units, num_layers=self.num_blocks,
                preprocessing=lambda x: scale * x)
        return ResidualNet(
            in_features=2 * d_id, out_features=out_features,
            hidden_features=self.hidden_units, num_blocks=self.num_blocks,
            use_norm=self.use_norm, preprocessing=periodic_features,
            context_features=self.context_features,
            dropout_probability=self.dropout_probability,
            compute_dtype=self.compute_dtype)

    # ----- params --------------------------------------------------------

    def init_params(self, key: jax.Array):
        d_id = len(self.identity_idx)
        net_key, _ = jax.random.split(key)
        net_params = self._net().init_params(
            key=net_key, init_identity=self.init_identity,
            identity_bias=IDENTITY_DERIVATIVE_CONSTANT)
        # Unconditional per-element spline on the identity half
        # (PiecewiseRationalQuadraticCDF identity init, coupling.py:207-214);
        # per-dim tails list -> num_bins + 1 derivative slots.
        uncond = {
            "widths": jnp.zeros((d_id, self.num_bins)),
            "heights": jnp.zeros((d_id, self.num_bins)),
            "derivatives": jnp.full((d_id, self.num_bins + 1),
                                    IDENTITY_DERIVATIVE_CONSTANT),
        }
        return {"net": net_params, "uncond": uncond}

    # ----- transforms ----------------------------------------------------

    def _apply_net(self, params, identity_split, context=None):
        if self.context_features:
            return self._net().apply(params["net"], identity_split,
                                     context=context)
        return self._net().apply(params["net"], identity_split)

    def _cond_spline_from_raw(self, raw, transform_split, inverse: bool):
        d_tr = len(self.transform_idx)
        raw = raw.reshape(raw.shape[0], d_tr, self._param_multiplier)
        nb = self.num_bins
        # softmax pre-scaling by sqrt(hidden) (coupling.py:340-345)
        scale = 1.0 / np.sqrt(self.hidden_units)
        uw = raw[..., :nb] * scale
        uh = raw[..., nb:2 * nb] * scale
        ud = raw[..., 2 * nb:]
        out, logdet = unconstrained_rational_quadratic_spline(
            transform_split, uw, uh, ud, inverse=inverse,
            tails=self._tails_transform, tail_bound=self.tail_bound,
            circular_tie=self.circular_tie)
        return out, sum_except_batch(logdet)

    def _conditional_spline(self, params, identity_split, transform_split,
                            inverse: bool, context=None):
        raw = self._apply_net(params, identity_split, context=context)
        return self._cond_spline_from_raw(raw, transform_split, inverse)

    def _unconditional_spline(self, params, identity_split, inverse: bool):
        u = params["uncond"]
        b = identity_split.shape[0]
        uw = jnp.broadcast_to(u["widths"], (b, *u["widths"].shape))
        uh = jnp.broadcast_to(u["heights"], (b, *u["heights"].shape))
        ud = jnp.broadcast_to(u["derivatives"], (b, *u["derivatives"].shape))
        out, logdet = unconstrained_rational_quadratic_spline(
            identity_split, uw, uh, ud, inverse=inverse,
            tails=self._tails_identity, tail_bound=self.tail_bound,
            circular_tie=self.circular_tie)
        return out, sum_except_batch(logdet)

    def _scatter(self, identity_split, transform_split):
        b = identity_split.shape[0]
        out = jnp.zeros((b, self.features), dtype=identity_split.dtype)
        out = out.at[:, self.identity_idx].set(identity_split)
        out = out.at[:, self.transform_idx].set(transform_split)
        return out

    def _coupling_forward(self, params, x, context=None):
        """``Coupling.forward`` (coupling.py:71-102): spline fwd + roll."""
        identity_split = x[:, self.identity_idx]
        transform_split = x[:, self.transform_idx]
        transform_out, logdet = self._conditional_spline(
            params, identity_split, transform_split, inverse=False,
            context=context)
        identity_out, logdet_id = self._unconditional_spline(
            params, identity_split, inverse=False)
        out = self._scatter(identity_out, transform_out)
        split = self.features // 2
        out = jnp.concatenate([out[:, split:], out[:, :split]], axis=1)
        return out, logdet + logdet_id

    def _coupling_inverse(self, params, x, context=None):
        """``Coupling.inverse`` (coupling.py:104-134): unroll + spline inv."""
        split = self.features // 2
        x = jnp.concatenate([x[:, split:], x[:, :split]], axis=1)
        identity_split = x[:, self.identity_idx]
        transform_split = x[:, self.transform_idx]
        identity_out, logdet = self._unconditional_spline(
            params, identity_split, inverse=True)
        transform_out, logdet_tr = self._conditional_spline(
            params, identity_out, transform_split, inverse=True,
            context=context)
        out = self._scatter(identity_out, transform_out)
        return out, logdet + logdet_tr

    # ----- flow-direction API (wrapper.py:269-275 swap) -------------------

    def forward(self, params, z, context=None):
        """Latent -> data (sampling direction)."""
        return self._coupling_inverse(params, z, context=context)

    def inverse(self, params, z, context=None):
        """Data -> latent (log_prob direction)."""
        return self._coupling_forward(params, z, context=context)

    def paired_forward_inverse(self, p_f, p_i, z_f, x_i, context=None):
        """One flow-forward step on ``(p_f, z_f)`` AND one flow-inverse
        step on ``(p_i, x_i)``, with the two conditioner nets evaluated as
        ONE batched ``(2, B, .)`` application (stacked params via vmap).

        The independence-move MH ratio needs both q(x_new) (a forward
        sweep) and q(x_old) (an inverse sweep) per proposal
        (``mcmc/hybrid.py``; reference ``MCMC/monte_carlo.py:264-268``
        runs them as two separate full-network passes).  The two sweeps
        are data-independent, and within ONE coupling the conditioner is
        the same function of (identity half, context) in both directions
        — only the cheap elementwise spline differs — so the paired step
        halves the serial depth of the proposal's dominant cost, the
        K-deep coupling chain.
        Numerics are the same algebra as the separate passes (asserted
        close by tests; the batched matmul may round differently).

        Returns ``((y_f, log_det_f), (y_i, log_det_i))`` exactly as the
        separate ``forward`` / ``inverse`` calls would.
        """
        split = self.features // 2
        # forward direction (= _coupling_inverse): unroll, uncond-inverse,
        # net on the post-uncond identity half, conditional spline inverse
        xf = jnp.concatenate([z_f[:, split:], z_f[:, :split]], axis=1)
        idf = xf[:, self.identity_idx]
        trf = xf[:, self.transform_idx]
        idf_out, ld_id_f = self._unconditional_spline(p_f, idf, inverse=True)
        # inverse direction (= _coupling_forward): net on the RAW identity
        # half, conditional spline forward, uncond-forward, roll at the end
        idi = x_i[:, self.identity_idx]
        tri = x_i[:, self.transform_idx]
        idi_out, ld_id_i = self._unconditional_spline(p_i, idi,
                                                      inverse=False)
        net = self._net()
        net_p2 = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]),
                                        p_f["net"], p_i["net"])
        ins2 = jnp.stack([idf_out, idi])
        if self.context_features:
            ctx2 = jnp.broadcast_to(context, (2,) + context.shape)
            raw2 = jax.vmap(
                lambda p, x, c: net.apply(p, x, context=c))(net_p2, ins2,
                                                            ctx2)
        else:
            raw2 = jax.vmap(net.apply)(net_p2, ins2)
        trf_out, ld_tr_f = self._cond_spline_from_raw(raw2[0], trf,
                                                      inverse=True)
        tri_out, ld_tr_i = self._cond_spline_from_raw(raw2[1], tri,
                                                      inverse=False)
        yf = self._scatter(idf_out, trf_out)
        yi = self._scatter(idi_out, tri_out)
        yi = jnp.concatenate([yi[:, split:], yi[:, :split]], axis=1)
        return (yf, ld_id_f + ld_tr_f), (yi, ld_tr_i + ld_id_i)


@dataclasses.dataclass(frozen=True)
class CoupledRationalQuadraticSpline(CircularSplineCoupling):
    """Linear-tail NSF coupling; reference ``wrapper.py:16-95``.

    Same machinery with ``tails='linear'`` on every dim and no periodic
    featurization (the param net sees the raw identity half).
    """

    ind_circ: Tuple[int, ...] = ()

    def _net(self):
        d_id = len(self.identity_idx)
        d_tr = len(self.transform_idx)
        out_features = d_tr * self._param_multiplier
        return ResidualNet(
            in_features=d_id, out_features=out_features,
            hidden_features=self.hidden_units, num_blocks=self.num_blocks,
            use_norm=False, preprocessing=None)
