"""bf16 compute-dtype path of the flow param nets (nets.py/_linear).

``compute_dtype='bfloat16'`` runs the training step and big-move flow
passes with bf16 matmuls.  These
tests pin the properties that make that safe:

* MH exactness: the spline params the net emits DEFINE the proposal q, and
  log q is computed from those same params — so the fused forward log-q and
  a separate inverse log_prob must agree to (f32) spline-roundtrip
  precision, bf16 net or not.  The net input (the identity half) is stored
  bit-exactly in the sample, so forward and inverse see bit-identical bf16
  nets.
* Training quality: the bf16 loss tracks the f32 loss; gradients stay f32
  (the optimizer state and params never leave f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flowstate.flows import build_circular_flow
from flowstate.training import TrainConfig, make_optimizer
from flowstate.training.train import TrainState, make_train_step

HALF_BOX = 5.0


def _flows():
    f32 = build_circular_flow(3, 2, HALF_BOX, K=3, hidden_units=32,
                              num_bins=8)
    bf16 = build_circular_flow(3, 2, HALF_BOX, K=3, hidden_units=32,
                               num_bins=8, compute_dtype="bfloat16")
    return f32, bf16


def test_bf16_shares_param_pytree_with_f32():
    f32, bf16 = _flows()
    p = f32.init_params(jax.random.key(0))
    q = bf16.init_params(jax.random.key(0))
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(q)):
        assert a.dtype == b.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_roundtrip_and_logq_consistency():
    _, bf16 = _flows()
    params = bf16.init_params(jax.random.key(1))
    x, log_q = bf16.sample_and_log_prob(params, jax.random.key(2), 256)
    assert x.dtype == jnp.float32

    # spline math is f32: roundtrip inversion stays f32-tight
    z = bf16.inverse(params, x)
    x2 = bf16.forward(params, z)
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), atol=2e-4)

    # MH consistency: fused forward log-q == inverse-pass log_prob
    lp = bf16.log_prob(params, x)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(log_q), atol=5e-3)


def test_bf16_density_close_to_f32():
    f32, bf16 = _flows()
    params = f32.init_params(jax.random.key(3))
    # train the f32 flow a moment so the net is NOT at identity init
    # (identity init zeroes the final layer, hiding dtype effects)
    x = jax.random.uniform(jax.random.key(4), (512, 6),
                           minval=-HALF_BOX, maxval=HALF_BOX)
    cfg = TrainConfig(batch_size=128, epochs=1, lr=1e-3)
    opt = make_optimizer(cfg)
    step = make_train_step(f32, cfg, opt)
    st = TrainState(params, opt.init(params), jax.random.key(5))
    for i in range(4):
        st, _ = step(st, x[i * 128:(i + 1) * 128])
    params = st.params

    lp32 = np.asarray(f32.log_prob(params, x[:256]))
    lp16 = np.asarray(bf16.log_prob(params, x[:256]))
    # bf16 perturbs the DISTRIBUTION slightly; densities stay close
    assert np.all(np.isfinite(lp16))
    np.testing.assert_allclose(lp16, lp32, atol=0.15)


def test_bf16_train_step_tracks_f32():
    f32, bf16 = _flows()
    cfg = TrainConfig(batch_size=64, epochs=1, lr=1e-3)
    data = jax.random.uniform(jax.random.key(6), (1024, 6),
                              minval=-HALF_BOX, maxval=HALF_BOX)
    losses = {}
    for name, model in (("f32", f32), ("bf16", bf16)):
        params = model.init_params(jax.random.key(7))
        opt = make_optimizer(cfg)
        step = jax.jit(make_train_step(model, cfg, opt))
        st = TrainState(params, opt.init(params), jax.random.key(8))
        hist = []
        for e in range(3):
            for i in range(16):
                st, loss = step(st, data[i * 64:(i + 1) * 64])
                hist.append(float(loss))
        losses[name] = hist
        # grads/params never leave f32
        for leaf in jax.tree_util.tree_leaves(st.params):
            assert leaf.dtype == jnp.float32
    assert np.isfinite(losses["bf16"]).all()
    # same trajectory to bf16 tolerance: final losses within 5%
    f, b = losses["f32"][-1], losses["bf16"][-1]
    assert abs(f - b) <= 0.05 * abs(f) + 0.02


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_bf16_layer_norm_stays_stable(direction):
    _, bf16 = _flows()
    params = bf16.init_params(jax.random.key(9))
    x = jax.random.uniform(jax.random.key(10), (128, 6),
                           minval=-HALF_BOX, maxval=HALF_BOX)
    fn = bf16.forward_and_log_det if direction == "forward" \
        else bf16.inverse_and_log_det
    out, ld = fn(params, x)
    assert np.isfinite(np.asarray(out)).all()
    assert np.isfinite(np.asarray(ld)).all()
