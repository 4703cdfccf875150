"""Flow training loops: forward/reverse KLD with NaN-skip, fully jitted.

Re-design of the reference training phases:

* Algorithm 1 pre-training — pure forward KLD, Adam, skip non-finite batches
  (``main_algorithm_1.py:297-320``).
* Algorithm 2 retraining — mixed loss
  ``alpha * forward_kld + (1 - alpha) * reverse_kld``
  (``main_algorithm_2.py:314-331, 437-456``) with a fresh optimizer per
  cycle.

Differences from the reference (documented):
* The whole epoch runs in one jitted ``lax.scan`` over pre-batched data —
  no per-batch host round-trips.
* NaN/Inf skipping is branchless: a non-finite loss zeroes the update but
  still advances the optimizer stream (the reference skips
  ``optimizer.step()`` entirely; both leave params unchanged on bad
  batches).
* ``weight_decay`` follows torch ``Adam``'s L2-in-gradient convention
  (reference main_algorithm_1.py:297), implemented as
  ``optax.add_decayed_weights`` *before* the Adam transform.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from flowstate.training.data import epoch_batches

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (defaults = Algorithm 1 full scale,
    main_algorithm_1.py:57-67)."""

    batch_size: int = 512
    epochs: int = 100
    lr: float = 1e-4
    weight_decay: float = 0.0
    alpha: float = 1.0           # fKLD weight; (1-alpha) on reverse KLD
    reverse_num_samples: int = 256


def make_optimizer(config: TrainConfig) -> optax.GradientTransformation:
    """Adam with torch-style (coupled) weight decay."""
    steps = [optax.add_decayed_weights(config.weight_decay)] \
        if config.weight_decay else []
    steps.append(optax.adam(config.lr))
    return optax.chain(*steps)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    key: jax.Array


def make_train_step(model, config: TrainConfig,
                    optimizer: optax.GradientTransformation):
    """Build a jitted single-batch update.

    Loss = alpha * forward_kld(batch) + (1-alpha) * reverse_kld (the fork's
    energy form).  A non-finite loss yields a zero update (NaN-skip,
    main_algorithm_1.py:310-314).
    """

    def loss_fn(params, batch, key):
        loss = 0.0
        if config.alpha > 0.0:
            loss = loss + config.alpha * model.forward_kld(params, batch)
        if config.alpha < 1.0:
            rkld, _ = model.reverse_kld(params, key,
                                        config.reverse_num_samples)
            loss = loss + (1.0 - config.alpha) * rkld
        return loss

    def step(state: TrainState, batch: jnp.ndarray
             ) -> Tuple[TrainState, jnp.ndarray]:
        key, k_loss = jax.random.split(state.key)
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch, k_loss)
        finite = jnp.isfinite(loss)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(finite, jnp.nan_to_num(g), jnp.zeros_like(g)),
            grads)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        updates = jax.tree_util.tree_map(
            lambda u: jnp.where(finite, u, jnp.zeros_like(u)), updates)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, key), loss

    return step


def train(model, params, data: jnp.ndarray, config: TrainConfig,
          key: jax.Array,
          opt_state: Optional[Any] = None,
          epoch_callback: Optional[Callable[[int, float], None]] = None):
    """Run ``config.epochs`` epochs over ``data`` (M, dim).

    Returns (params, opt_state, loss_history, loss_epoch) mirroring the
    reference's bookkeeping (per-batch ``loss_hist`` and per-epoch
    ``loss_epoch``, main_algorithm_1.py:294-319).
    """
    optimizer = make_optimizer(config)
    if opt_state is None:
        opt_state = optimizer.init(params)
    step = make_train_step(model, config, optimizer)

    # donate the carried TrainState: params/opt-state buffers are dead after
    # each epoch call, so XLA may update Adam moments and params in place.
    #
    # The shuffled batch tensor is a program ARGUMENT of the epoch program,
    # produced by its own eagerly-dispatched jit, so the scan consumes an
    # input buffer rather than xs computed in the same program.  The
    # next epoch's shuffle is dispatched BEFORE syncing the current epoch
    # (async prefetch), so its cost hides behind the epoch's compute.
    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_epoch(state: TrainState, batches):
        state, losses = jax.lax.scan(step, state, batches)
        return state, losses

    data = jnp.asarray(data)
    shuffle = jax.jit(
        lambda k: epoch_batches(k, data, config.batch_size))

    key, loop_key = jax.random.split(key)
    epoch_keys = jax.random.split(loop_key, config.epochs)
    state = TrainState(params, opt_state, key)
    loss_history = []
    loss_epoch = []
    batches = shuffle(epoch_keys[0]) if config.epochs else None
    for epoch in range(config.epochs):
        nxt = (shuffle(epoch_keys[epoch + 1])
               if epoch + 1 < config.epochs else None)
        state, losses = run_epoch(state, batches)
        batches = nxt
        losses = jax.device_get(losses)
        loss_history.extend(losses.tolist())
        finite = losses[jnp.isfinite(losses)] if losses.size else losses
        mean_loss = float(finite.mean()) if finite.size else float("nan")
        loss_epoch.append(mean_loss)
        if epoch_callback is not None:
            epoch_callback(epoch, mean_loss)
    return state.params, state.opt_state, loss_history, loss_epoch
