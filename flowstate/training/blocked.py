"""Training loop for the blocked conditional flow.

Conditional maximum likelihood on (block, context) pairs cut from MCMC
configurations: every epoch re-draws a fresh uniformly-random k-subset per
configuration (the same distribution the sampler uses at proposal time,
``mcmc/blocked.py``), so the conditioner trains against the exact random
context ordering it will see.  Loss = -E[ log q(x_block | rest) ] — the
conditional form of the reference's ``forward_kld`` (core.py:88-103).

Same discipline as ``training/train.py``: the (x, context) batch
tensors are PROGRAM ARGUMENTS of one flat jitted scan, the
augmentation runs in its own eagerly-dispatched jit with async prefetch,
and the carried TrainState is donated.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from flowstate.mcmc.blocked import (
    block_context, random_block_onehots, select_particles,
)
from flowstate.training.train import TrainConfig, TrainState, make_optimizer


def blocked_pairs(key: jax.Array, configs: jnp.ndarray, k: int,
                  half_box: float,
                  context_fn=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(S, N, 2) BOX-frame configs -> ((S, 2k) centered blocks, (S, C) ctx).

    One random block per configuration; ``configs`` are in the MC box
    frame [0, L)^2 (the blocks are centered here, matching the flow's
    torus and ``blocked_big_moves``).  ``context_fn`` must match the one
    the sampler will use (default: raw-coords ``block_context``).
    """
    s, n = configs.shape[:2]
    if context_fn is None:
        context_fn = lambda r, p: block_context(r, p, half_box)  # noqa: E731
    sel, rest = random_block_onehots(key, s, n, k)
    x = (select_particles(sel, configs) - half_box).reshape(s, -1)
    ctx = context_fn(rest, configs)
    return x, ctx


def make_blocked_train_step(model, config: TrainConfig,
                            optimizer: optax.GradientTransformation):
    """Single-batch conditional-MLE update with the NaN-skip guard."""

    def loss_fn(params, x, ctx):
        return -jnp.mean(model.log_prob(params, x, context=ctx))

    def step(state: TrainState, batch) -> Tuple[TrainState, jnp.ndarray]:
        x, ctx = batch
        key, _ = jax.random.split(state.key)
        loss, grads = jax.value_and_grad(loss_fn)(state.params, x, ctx)
        finite = jnp.isfinite(loss)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(finite, jnp.nan_to_num(g),
                                jnp.zeros_like(g)), grads)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        updates = jax.tree_util.tree_map(
            lambda u: jnp.where(finite, u, jnp.zeros_like(u)), updates)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, key), loss

    return step


def train_blocked(model, params, configs: jnp.ndarray, k: int,
                  half_box: float, config: TrainConfig, key: jax.Array,
                  opt_state: Optional[Any] = None,
                  context_fn=None):
    """``config.epochs`` of conditional MLE over (S, N, 2) box-frame data.

    Returns ``(params, opt_state, loss_epoch)``.
    """
    optimizer = make_optimizer(config)
    if opt_state is None:
        opt_state = optimizer.init(params)
    step = make_blocked_train_step(model, config, optimizer)

    configs = jnp.asarray(configs)
    s = configs.shape[0]
    n_steps = s // config.batch_size
    if n_steps == 0:
        raise ValueError(
            f"{s} configs < batch_size {config.batch_size}")

    @jax.jit
    def make_epoch(ek):
        """Fresh block assignment + shuffle -> (n_steps, B, ...) tensors."""
        k_blk, k_shuf = jax.random.split(ek)
        x, ctx = blocked_pairs(k_blk, configs, k, half_box,
                               context_fn=context_fn)
        order = jax.random.permutation(k_shuf, s)[: n_steps
                                                  * config.batch_size]
        x = x[order].reshape(n_steps, config.batch_size, -1)
        ctx = ctx[order].reshape(n_steps, config.batch_size, -1)
        return x, ctx

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_epoch(state: TrainState, batches):
        state, losses = jax.lax.scan(step, state, batches)
        return state, losses

    key, loop_key = jax.random.split(key)
    epoch_keys = jax.random.split(loop_key, max(config.epochs, 1))
    state = TrainState(params, opt_state, key)
    loss_epoch = []
    batches = make_epoch(epoch_keys[0]) if config.epochs else None
    for epoch in range(config.epochs):
        nxt = (make_epoch(epoch_keys[epoch + 1])
               if epoch + 1 < config.epochs else None)
        state, losses = run_epoch(state, batches)
        batches = nxt
        losses = jax.device_get(losses)
        finite = losses[jnp.isfinite(losses)] if losses.size else losses
        loss_epoch.append(float(finite.mean()) if finite.size
                          else float("nan"))
    return state.params, state.opt_state, loss_epoch
