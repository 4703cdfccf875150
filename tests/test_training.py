"""Tests for the training pipeline: data, optimizer, NaN-skip, learning."""

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.flows import DoubleWellLJ, build_circular_flow
from flowstate.training import (
    TrainConfig, dedup_subsample, epoch_batches, flatten_configs,
    make_optimizer, make_train_step, sliding_window_update, train, TrainState,
)

BOUND = 5.0
D = 6


def _small_model(target=None):
    return build_circular_flow(3, 2, BOUND, K=2, hidden_units=16,
                               num_bins=4, num_blocks=1, target=target)


def test_flatten_and_dedup():
    configs = np.zeros((10, 3, 2))
    flat = flatten_configs(configs, 3, 2)
    assert flat.shape == (10, 6) and flat.dtype == np.float32
    uniq = dedup_subsample(flat)
    assert uniq.shape == (1, 6)
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    sub = dedup_subsample(data, max_samples=4)
    assert sub.shape == (4, 2)


def test_epoch_batches_shapes():
    data = jnp.arange(100.0).reshape(25, 4)
    batches = epoch_batches(jax.random.key(0), data, 8)
    assert batches.shape == (3, 8, 4)  # 25 // 8 = 3, remainder dropped
    # permutation covers distinct rows
    rows = np.asarray(batches).reshape(-1, 4)[:, 0]
    assert len(np.unique(rows)) == 24


def test_sliding_window_update():
    old = np.zeros((5, 6))
    new = np.ones((3, 6))
    cum = sliding_window_update(old, new, cumulative=True)
    assert cum.shape == (8, 6)
    fresh = sliding_window_update(old, new, cumulative=False)
    assert fresh.shape == (3, 6) and np.all(fresh == 1)
    win = sliding_window_update(old, new, cumulative=False, window_size=6)
    assert win.shape == (6, 6) and win.sum() == 3 * 6


def test_train_reduces_loss_toward_target():
    """A 2-layer flow trained on a blob must beat the uniform baseline."""
    model = _small_model()
    params = model.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    # target: tight Gaussian blob at the left well center (-2.5, 0) x3
    center = np.tile([-2.5, 0.0], 3)
    data = jnp.asarray(
        (center + 0.3 * rng.standard_normal((2048, D))).astype(np.float32))
    config = TrainConfig(batch_size=256, epochs=12, lr=5e-3)
    new_params, _, loss_hist, loss_epoch = train(
        model, params, data, config, jax.random.key(1))
    uniform_nll = D * np.log(2 * BOUND)  # loss of the identity-init flow
    assert loss_epoch[-1] < loss_epoch[0]
    assert loss_epoch[-1] < uniform_nll - 1.0  # actually learned structure
    # density should now be much higher at the blob than far away
    lp_blob = model.log_prob(new_params, data[:16])
    far = jnp.asarray(np.tile([2.5, 0.0], 3)[None, :].astype(np.float32))
    lp_far = model.log_prob(new_params, far)
    assert float(lp_blob.mean()) > float(lp_far[0]) + 2.0


def test_nan_skip_keeps_params_unchanged():
    """A non-finite loss must produce a zero update (main_algorithm_1.py:310-314).

    Note: pathological *inputs* (inf/nan coords) do NOT produce a bad loss —
    the identity tails pass them through with zero log-det — so the bad loss
    is forced through poisoned spline params on one layer."""
    model = _small_model()
    params = model.init_params(jax.random.key(0))
    # poison one layer's unconditional spline derivatives -> NaN log-det
    poisoned = list(params)
    layer0 = jax.tree_util.tree_map(lambda x: x, poisoned[0])
    layer0["uncond"]["derivatives"] = jnp.full_like(
        layer0["uncond"]["derivatives"], jnp.nan)
    poisoned[0] = layer0
    poisoned = tuple(poisoned)

    config = TrainConfig(batch_size=4, epochs=1, lr=1e-3)
    optimizer = make_optimizer(config)
    step = make_train_step(model, config, optimizer)
    state = TrainState(poisoned, optimizer.init(poisoned), jax.random.key(2))
    batch = jnp.zeros((4, D), dtype=jnp.float32)
    new_state, loss = step(state, batch)
    assert not np.isfinite(float(loss))
    for a, b in zip(jax.tree_util.tree_leaves(poisoned),
                    jax.tree_util.tree_leaves(new_state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mixed_loss_runs():
    target = DoubleWellLJ(dim=D, n_particles=3, temperature=1.0, bound=BOUND,
                          V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    model = _small_model(target=target)
    params = model.init_params(jax.random.key(0))
    data = jnp.asarray(np.random.default_rng(0).uniform(
        -BOUND, BOUND, size=(64, D)).astype(np.float32))
    config = TrainConfig(batch_size=32, epochs=2, lr=1e-3, alpha=0.7,
                         reverse_num_samples=16)
    new_params, _, hist, _ = train(model, params, data, config,
                                   jax.random.key(3))
    assert len(hist) == 4  # 2 epochs x 2 batches
