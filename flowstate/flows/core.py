"""The NormalizingFlow model: pure-functional flow algebra.

Equivalent of the reference ``NF/normflows/core.py``
(``NormalizingFlow``, ``core.py:10-230``).  The model object holds only
static config (base distribution + layer configs); the trainable state is a
params pytree, so every method is a pure jittable function of
``(params, batch)`` and the whole model vmaps/shards trivially.

API parity map (reference -> here):
  forward / forward_and_log_det     core.py:28-56
  inverse / inverse_and_log_det     core.py:58-86
  forward_kld                       core.py:88-103  (the fork omits the base
      log-prob at core.py:102 — valid for the uniform base since it is
      constant in bounds; ``include_base=True`` restores it)
  reverse_kld                       core.py:105-142 (the fork's energy form:
      returns (mean(E(z)) + mean(log_q), z))
  sample                            core.py:178-196 (bare samples)
  log_prob                          core.py:198-214
  save / load                       core.py:216-230 (numpy npz of the pytree)
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class NormalizingFlow:
    """A chain of flow layers over a base distribution.

    ``base`` must expose ``sample(key, n)`` and ``log_prob(z)``; each layer
    config must expose ``init_params(key)``, ``forward(params, z)`` and
    ``inverse(params, z)`` returning ``(z, log_det)``.
    ``target`` (optional) must expose ``energy(x)`` for reverse_kld.
    """

    base: Any
    layers: Tuple[Any, ...]
    target: Optional[Any] = None

    # ----- params --------------------------------------------------------

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, len(self.layers))
        return tuple(layer.init_params(k)
                     for layer, k in zip(self.layers, keys))

    # ----- transforms (reference core.py:28-86) ---------------------------

    def forward(self, params, z: jnp.ndarray) -> jnp.ndarray:
        for layer, p in zip(self.layers, params):
            z, _ = layer.forward(p, z)
        return z

    def forward_and_log_det(self, params, z: jnp.ndarray):
        log_det = jnp.zeros(z.shape[0], dtype=z.dtype)
        for layer, p in zip(self.layers, params):
            z, ld = layer.forward(p, z)
            log_det = log_det + ld
        return z, log_det

    def inverse(self, params, x: jnp.ndarray) -> jnp.ndarray:
        for layer, p in zip(reversed(self.layers), reversed(params)):
            x, _ = layer.inverse(p, x)
        return x

    def inverse_and_log_det(self, params, x: jnp.ndarray):
        log_det = jnp.zeros(x.shape[0], dtype=x.dtype)
        for layer, p in zip(reversed(self.layers), reversed(params)):
            x, ld = layer.inverse(p, x)
            log_det = log_det + ld
        return x, log_det

    # ----- losses ---------------------------------------------------------

    def forward_kld(self, params, x: jnp.ndarray,
                    include_base: bool = False) -> jnp.ndarray:
        """Max-likelihood loss; reference ``core.py:88-103``.

        The fork omits the base log-prob (constant for the in-bounds uniform
        base); pass ``include_base=True`` for the full -E[log q(x)].
        """
        z, log_q = self.inverse_and_log_det(params, x)
        if include_base:
            log_q = log_q + self.base.log_prob(z)
        return -jnp.mean(log_q)

    def reverse_kld(self, params, key: jax.Array, num_samples: int):
        """Energy-based reverse KLD; reference ``core.py:105-142``.

        Draws z ~ base, pushes through the flow accumulating -log_det, and
        returns ``(mean(target.energy(x)) + mean(log_q), x)`` — the fork's
        tuple form.
        """
        if self.target is None:
            raise ValueError("reverse_kld requires a target with .energy()")
        z = self.base.sample(key, num_samples)
        log_q = jnp.zeros(num_samples, dtype=z.dtype)
        for layer, p in zip(self.layers, params):
            z, ld = layer.forward(p, z)
            log_q = log_q - ld
        energy = self.target.energy(z)
        return jnp.mean(energy) + jnp.mean(log_q), z

    # ----- sampling / density (reference core.py:178-214) ----------------

    def sample(self, params, key: jax.Array, num_samples: int) -> jnp.ndarray:
        z = self.base.sample(key, num_samples)
        return self.forward(params, z)

    def sample_and_log_prob(self, params, key: jax.Array, num_samples: int):
        """Samples plus their log q — one pass, no extra inverse sweep.

        (The reference computes sample() then log_prob() separately inside
        ``nf_big_move``; fusing them halves the flow work per proposal.)
        """
        z = self.base.sample(key, num_samples)
        log_q = self.base.log_prob(z)
        for layer, p in zip(self.layers, params):
            z, ld = layer.forward(p, z)
            log_q = log_q - ld
        return z, log_q

    def log_prob(self, params, x: jnp.ndarray) -> jnp.ndarray:
        z, log_q = self.inverse_and_log_det(params, x)
        return log_q + self.base.log_prob(z)

    def sample_and_log_prob_with_old(self, params, key: jax.Array,
                                     num_samples: int, x_old: jnp.ndarray):
        """``(x_new, log_q_new, log_q_old)`` — the independence move's full
        flow work in one lockstep pass.

        The MH ratio of a flow independence move needs q at the proposal
        (forward sweep) AND at the current point (inverse sweep); run as
        separate calls these are 2K serial coupling steps.  When the stack
        is a single ``ScannedLayers`` the two sweeps run in ONE K-step
        scan with the per-step conditioner nets batched
        (``paired_forward_inverse``); otherwise falls back to the separate
        passes.  Same algebra either way (tests assert closeness).
        """
        z = self.base.sample(key, num_samples)
        lq0 = self.base.log_prob(z)
        if _supports_paired(self.layers):
            (x_new, ld_f), (z_old, ld_i) = (
                self.layers[0].paired_forward_inverse(params[0], z, x_old))
            return x_new, lq0 - ld_f, ld_i + self.base.log_prob(z_old)
        x_new, ld_f = self.forward_and_log_det(params, z)
        return x_new, lq0 - ld_f, self.log_prob(params, x_old)

    # ----- persistence (reference core.py:216-230) ------------------------

    def save(self, params, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(jax.device_get(params), f)

    def load(self, path: str):
        with open(path, "rb") as f:
            return jax.tree_util.tree_map(jnp.asarray, pickle.load(f))


def build_circular_flow(num_particles: int, num_dim: int, half_box: float,
                        K: int = 15, hidden_units: int = 256,
                        num_bins: int = 32, num_blocks: int = 2,
                        net_type: str = "residual",
                        target: Optional[Any] = None,
                        scan_layers: bool = True,
                        compute_dtype: Optional[str] = None
                        ) -> NormalizingFlow:
    """The hybrid experiments' flow: uniform torus base + K circular couplings.

    Mirrors the model construction of ``main_algorithm_1.py:276-284`` /
    ``main_algorithm_2.py:281-295`` (without replicating the reference's
    NUM_BINS-as-num_blocks positional mixup, SURVEY.md §7).

    ``scan_layers=True`` (default) applies the K identical-config layers via
    ``lax.scan`` over stacked params — numerically identical, ~K-times
    smaller compiled graph (an unrolled 23-layer training graph compiles
    many times slower).
    """
    from flowstate.flows.coupling import CircularSplineCoupling
    from flowstate.flows.distributions import UniformParticle

    dim = num_particles * num_dim
    base = UniformParticle(num_particles, num_dim, half_box)
    layer = CircularSplineCoupling(
        features=dim, num_blocks=num_blocks, hidden_units=hidden_units,
        ind_circ=tuple(range(dim)), num_bins=num_bins,
        tail_bound=half_box, net_type=net_type,
        compute_dtype=compute_dtype)
    if scan_layers:
        layers = (ScannedLayers(layer, K),)
    else:
        layers = tuple(
            dataclasses.replace(layer) for _ in range(K))
    return NormalizingFlow(base=base, layers=layers, target=target)


def build_conditional_circular_flow(block_particles: int, num_dim: int,
                                    half_box: float,
                                    context_features: int,
                                    K: int = 10, hidden_units: int = 256,
                                    num_bins: int = 16, num_blocks: int = 2,
                                    scan_layers: bool = True
                                    ) -> "ConditionalNormalizingFlow":
    """Conditional circular flow over a k-particle BLOCK given the rest.

    The proposal distribution of the blocked big move (``mcmc/blocked.py``):
    a uniform torus base over the block's 2k coordinates pushed through K
    context-conditioned circular spline couplings.  The context (periodic
    features of the other N-k particles' coordinates) gates every
    coupling's ResidualNet through a GLU — the conditioning machinery the
    reference ships but never uses for proposals
    (``NF/normflows/core.py:233-383`` + ``nets/resnet.py:48-49``).
    """
    from flowstate.flows.coupling import CircularSplineCoupling
    from flowstate.flows.distributions import UniformParticle
    from flowstate.flows.models import ConditionalNormalizingFlow

    dim = block_particles * num_dim
    base = UniformParticle(block_particles, num_dim, half_box)
    layer = CircularSplineCoupling(
        features=dim, num_blocks=num_blocks, hidden_units=hidden_units,
        ind_circ=tuple(range(dim)), num_bins=num_bins,
        tail_bound=half_box, net_type="residual",
        context_features=context_features)
    if scan_layers:
        layers = (ScannedLayers(layer, K),)
    else:
        layers = tuple(dataclasses.replace(layer) for _ in range(K))
    return ConditionalNormalizingFlow(base=base, layers=layers)


def _supports_paired(layers) -> bool:
    """True when the stack is a single ``ScannedLayers`` whose inner layer
    implements the paired lockstep step (used by
    ``sample_and_log_prob_with_old`` to pick the fused path)."""
    if len(layers) != 1 or not hasattr(layers[0], "paired_forward_inverse"):
        return False
    inner = getattr(layers[0], "layer", None)
    return inner is None or hasattr(inner, "paired_forward_inverse")


@dataclasses.dataclass(frozen=True)
class ScannedLayers:
    """K structurally-identical layers applied via ``lax.scan``.

    Compile-time optimization: the unrolled K-layer flow produces a graph
    with K copies of the coupling body (the reference's hybrid configs use
    K = 15-23), which is slow to compile; scanning over stacked params puts
    ONE body in the graph.  Numerically identical to the unrolled chain —
    asserted by tests — because every hybrid layer shares one static config
    (the reference also stacks identical layers, main_algorithm_1.py:280-283).

    ``remat`` (default True) wraps the layer body in ``jax.checkpoint``: the
    backward pass recomputes the RQ-spline intermediates instead of loading
    them from device memory, trading spare FLOPs for bytes.  Whether that
    pays on the H100 is not measured yet (ROADMAP S5).  Gradients are
    numerically identical (same values, recomputed).
    """

    layer: Any
    K: int
    remat: bool = True

    def init_params(self, key: jax.Array):
        keys = jax.random.split(key, self.K)
        return jax.vmap(self.layer.init_params)(keys)

    def _body(self, direction: str, has_context: bool):
        fn = getattr(self.layer, direction)
        if has_context:
            step = lambda p, z, c: fn(p, z, context=c)  # noqa: E731
        else:
            step = lambda p, z, c: fn(p, z)             # noqa: E731
        return jax.checkpoint(step) if self.remat else step

    def _scan(self, params, z, context, direction: str, reverse: bool):
        step = self._body(direction, context is not None)

        def body(carry, p):
            z, ld = carry
            z, d = step(p, z, context)
            return (z, ld + d), None

        ld0 = jnp.zeros_like(z[:, 0])
        (z, ld), _ = jax.lax.scan(body, (z, ld0), params, reverse=reverse)
        return z, ld

    def forward(self, params, z, context=None):
        return self._scan(params, z, context, "forward", reverse=False)

    def inverse(self, params, z, context=None):
        return self._scan(params, z, context, "inverse", reverse=True)

    def paired_forward_inverse(self, params, z_f, x_i, context=None):
        """Forward chain on ``z_f`` and inverse chain on ``x_i`` in ONE
        K-step scan: step t applies layer t forward and layer K-1-t
        inverse via the coupling's paired step (batched conditioner —
        see ``CircularSplineCoupling.paired_forward_inverse``).  Halves
        the serial scan depth of sample+old-log_prob versus running the
        two chains as separate scans.
        """
        if context is not None:
            step = lambda pf, pi, zf, xi, c: (            # noqa: E731
                self.layer.paired_forward_inverse(pf, pi, zf, xi,
                                                  context=c))
        else:
            step = lambda pf, pi, zf, xi, c: (            # noqa: E731
                self.layer.paired_forward_inverse(pf, pi, zf, xi))
        if self.remat:
            step = jax.checkpoint(step)
        rev = jax.tree_util.tree_map(lambda a: jnp.flip(a, 0), params)

        def body(carry, ps):
            (zf, ldf), (xi, ldi) = carry
            pf, pi = ps
            (zf, df), (xi, di) = step(pf, pi, zf, xi, context)
            return ((zf, ldf + df), (xi, ldi + di)), None

        carry0 = ((z_f, jnp.zeros_like(z_f[:, 0])),
                  (x_i, jnp.zeros_like(x_i[:, 0])))
        (out_f, out_i), _ = jax.lax.scan(body, carry0, (params, rev))
        return out_f, out_i


def generate_samples(model: NormalizingFlow, params, key: jax.Array,
                     n_iterations: int, samples_per_iteration: int = 5000,
                     num_particles: Optional[int] = None,
                     num_dim: Optional[int] = None):
    """Chunked sampling helper; reference ``hybrid_NF_MCMC/utils.py``
    ``generate_samples`` (5000-sample chunks to bound device memory).

    Returns (n_iterations * samples_per_iteration, N, d) if particle shape
    is given, else the flat (M, dim) array.
    """
    import numpy as np

    chunks = []
    for i in range(n_iterations):
        key, k = jax.random.split(key)
        chunks.append(np.asarray(model.sample(params, k,
                                              samples_per_iteration)))
    out = np.concatenate(chunks, axis=0)
    if num_particles is not None and num_dim is not None:
        out = out.reshape(-1, num_particles, num_dim)
    return out
