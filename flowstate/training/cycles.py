"""Fused on-device Algorithm-2 cycles: the whole outer loop as one scan.

The reference's Algorithm 2 (``main_algorithm_2.py:393-577``) — and this
repo's faithful re-implementation (``experiments/algorithm2.py``) — drives
every cycle from the host: produce, fetch samples, rebuild a dataloader,
retrain, push a proposal batch.  Each of those host round trips can cost
more than the cycle's compute.

With the reference's own full-scale settings the cycle is STATIC: the
sliding window is non-cumulative (``CUMULATIVE_TRAINING_SAMPLES=False``,
ref :41-44), so the train set is exactly the ``UPDATE_NUM_SAMPLES`` fresh
samples of the cycle, and the loss is pure forward KLD (alpha=1, ref :52).
Static shapes mean the ENTIRE cycle — production segment, fresh-optimizer
retrain, flow big moves — composes into one ``lax.scan`` over cycles that
never touches the host.  The host syncs once per checkpoint interval to
write metrics/plots/checkpoints.

Semantics preserved per cycle (same key-stream discipline as the unfused
path): produce ``update_num_samples`` across chains -> train ``epochs``
epochs with a FRESH Adam on exactly those samples -> one flow big move
per chain.  The only deviation is bookkeeping granularity: losses and
acceptance counters come back stacked per cycle instead of logged live.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from flowstate.mcmc import nf_big_moves, run_production_batch
from flowstate.mcmc.hybrid import to_centered
from flowstate.training.data import epoch_batches
from flowstate.training.train import (
    TrainConfig, TrainState, make_optimizer, make_train_step,
)


def make_fused_cycles(model, spec, config, n_cycles: int,
                      train: bool = True):
    """Build a jitted runner for ``n_cycles`` Algorithm-2 cycles.

    Requires the A2 full-scale regime: non-cumulative window and
    alpha = 1.0 (pure forward KLD).  Returns
    ``run(params, state, key) -> (params, state, key, out)`` with
    ``out = {"loss": (n_cycles, epochs), "accepts": (n_cycles,),
    "positions": (n_cycles, C, T, N, 2)}``.

    ``train=False`` builds FROZEN cycles — production + big moves with the
    flow params held fixed (losses come back as NaN).  This is the
    finite-adaptation mode: the reference's Algorithm 2 retrains forever
    (``main_algorithm_2.py:393-577``), which leaves a small stationary
    bias in absolute sector occupancies (SECTORS.md); freezing after a
    warm-up makes the remaining chain a fixed-kernel Markov chain whose
    big move satisfies detailed balance exactly, so post-freeze samples
    are asymptotically unbiased.
    """
    if config.cumulative_training_samples:
        raise ValueError("fused cycles need the non-cumulative window "
                         "(static train-set shape)")
    if config.alpha < 1.0:
        raise ValueError("fused cycles support the alpha=1.0 (pure fKLD) "
                         "regime the reference's full scale uses")

    beta, half_box = config.beta, config.half_box
    c = config.num_chains
    samples_per_chain = max(1, config.update_num_samples // c)
    train_cfg = TrainConfig(batch_size=config.batch_size,
                            epochs=config.epochs, lr=config.lr,
                            weight_decay=config.weight_decay,
                            alpha=config.alpha)
    optimizer = make_optimizer(train_cfg)
    step = make_train_step(model, train_cfg, optimizer)

    def one_cycle(carry, _):
        params, state, key = carry

        # 1) production -- ref :399-418
        state, obs = run_production_batch(spec, beta, state,
                                          samples_per_chain,
                                          config.sampling_frequency)

        if train:
            window = to_centered(
                obs.positions.reshape(-1, spec.num_particles, 2), half_box)

            # 2+3) fresh optimizer + retrain on the window -- ref :421-456
            key, k_shuffle, k_train = jax.random.split(key, 3)
            ts = TrainState(params, optimizer.init(params), k_train)

            def run_epoch(ts, k):
                batches = epoch_batches(k, window, train_cfg.batch_size)
                ts, losses = jax.lax.scan(step, ts, batches)
                return ts, jnp.mean(losses)

            ts, epoch_losses = jax.lax.scan(
                run_epoch, ts, jax.random.split(k_shuffle, train_cfg.epochs))
            params = ts.params
        else:  # frozen: params fixed, no retrain
            epoch_losses = jnp.full((train_cfg.epochs,), jnp.nan)

        # 4) one flow big move per chain -- ref :534-548
        res = nf_big_moves(spec, beta, state, model, params, half_box)
        out = {"loss": epoch_losses,
               "accepts": jnp.sum(res.accepted.astype(jnp.int32)),
               "positions": obs.positions}
        return (params, res.state, key), out

    @jax.jit
    def run(params, state, key):
        (params, state, key), out = jax.lax.scan(
            one_cycle, (params, state, key), None, length=n_cycles)
        return params, state, key, out

    return run
