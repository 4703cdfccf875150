"""Fixed-weights full-flow parity vs the PyTorch fork (SURVEY.md §7.3).

The spline-*function* parity test (tests/test_splines.py:129-167) cannot
catch a mask-assignment, feature-roll, periodic-featurization-scale, or
unconditional-CDF wiring mismatch in the assembled layer (VERDICT r2,
missing #1).  These tests transplant one set of weights from the actual
torch fork's ``CircularCoupledRationalQuadraticSpline`` stack
(``NF/normflows/flows/neural_spline/wrapper.py:98-275`` +
``coupling.py:16-368`` + ``core.py:198-214``) into the flowstate stack and
assert forward / inverse / log_prob agree in fp64 on fixed inputs.

Bug-compat knobs for exactness: ``circular_tie=False`` (the fork's list-
tails circular tie is a no-op — ops/splines.py docstring) and the fork's
BatchNorm disabled per block (our LayerNorm swap is the one documented
architectural deviation; everything else must match to float64 precision).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

REF_NF_PATH = "/root/reference/NF"


def _import_fork():
    if REF_NF_PATH not in sys.path:
        sys.path.insert(0, REF_NF_PATH)
    import normflows  # noqa: F401  (the fork)
    return normflows


def _t2j(t):
    return jnp.asarray(t.detach().cpu().numpy().astype(np.float64))


def _linear_params(mod):
    """torch nn.Linear -> our {'w': (in,out), 'b': (out,)} convention."""
    return {"w": _t2j(mod.weight).T, "b": _t2j(mod.bias)}


def _transplant_resnet(tnet):
    """torch fork ResidualNet (resnet.py:53-104) -> flowstate pytree."""
    params = {"initial": _linear_params(tnet.initial_layer), "blocks": []}
    for blk in tnet.blocks:
        entry = {"l1": _linear_params(blk.linear_layers[0]),
                 "l2": _linear_params(blk.linear_layers[1])}
        if getattr(tnet, "context_features", None):
            entry["ctx"] = _linear_params(blk.context_layer)
        params["blocks"].append(entry)
    params["final"] = _linear_params(tnet.final_layer)
    return params


def _transplant_layer(tlayer):
    """fork CircularCoupledRQS -> flowstate CircularSplineCoupling params."""
    prqct = tlayer.prqct
    uncond = prqct.unconditional_transform
    return {
        "net": _transplant_resnet(prqct.transform_net),
        "uncond": {
            "widths": _t2j(uncond.unnormalized_widths),
            "heights": _t2j(uncond.unnormalized_heights),
            "derivatives": _t2j(uncond.unnormalized_derivatives),
        },
    }


def _disable_batchnorm(model):
    """Neutralize the fork's per-block BatchNorm (wrapper.py:177 hardcodes
    use_batch_norm=True); the LayerNorm swap is flowstate's documented
    deviation, so parity is asserted on everything else."""
    for m in model.modules():
        if m.__class__.__name__ == "ResidualBlock":
            m.use_batch_norm = False


def test_full_circular_flow_parity_vs_fork(rng):
    """K-layer assembled-stack parity: forward, inverse, log_prob (fp64)."""
    nf = _import_fork()

    n_particles, n_dim, k_layers = 3, 2, 3
    d = n_particles * n_dim
    hidden, n_blocks, n_bins = 16, 2, 4
    bound = 5.0

    torch.manual_seed(7)
    base_t = nf.Energy.UniformParticle(n_particles, n_dim, bound,
                                       device="cpu")
    layers_t = [
        nf.flows.CircularCoupledRationalQuadraticSpline(
            d, n_blocks, hidden, list(range(d)), num_bins=n_bins,
            tail_bound=bound, init_identity=False)
        for _ in range(k_layers)
    ]
    model_t = nf.NormalizingFlow(base_t, layers_t).double().eval()
    _disable_batchnorm(model_t)
    # randomize ALL weights away from the near-identity init so a wiring
    # mismatch cannot hide behind an identity transform
    with torch.no_grad():
        for p in model_t.parameters():
            p.copy_(torch.empty_like(p).uniform_(-0.8, 0.8))

    from flowstate.flows import NormalizingFlow, UniformParticle
    from flowstate.flows.coupling import CircularSplineCoupling

    layer_j = CircularSplineCoupling(
        features=d, num_blocks=n_blocks, hidden_units=hidden,
        ind_circ=tuple(range(d)), num_bins=n_bins, tail_bound=bound,
        use_norm=False, circular_tie=False)
    model_j = NormalizingFlow(
        base=UniformParticle(n_particles, n_dim, bound),
        layers=tuple(layer_j for _ in range(k_layers)))

    x = rng.uniform(-bound, bound, size=(37, d)).astype(np.float64)

    with jax.enable_x64(True):
        # transplant INSIDE the x64 context: jnp.asarray silently downcasts
        # float64 to float32 otherwise, capping parity at fp32 noise
        params = tuple(_transplant_layer(l) for l in layers_t)
        with torch.no_grad():
            y_t, ld_t = model_t.forward_and_log_det(torch.tensor(x))
            lp_t = model_t.log_prob(torch.tensor(x))
        y_j, ld_j = model_j.forward_and_log_det(params, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y_j), y_t.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(ld_j), ld_t.numpy(), atol=1e-6)

        with torch.no_grad():
            z_t, ldi_t = model_t.inverse_and_log_det(torch.tensor(x))
        z_j, ldi_j = model_j.inverse_and_log_det(params, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(z_j), z_t.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(ldi_j), ldi_t.numpy(),
                                   atol=1e-6)

        # 1e-5: the fork's UniformParticle computes its base constant in
        # float32 (Uniform.py:72), a ~3e-6 absolute wobble on the fp64 path
        lp_j = model_j.log_prob(params, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(lp_j), lp_t.numpy(), atol=1e-5)


def test_context_glu_residualnet_parity_vs_fork(rng):
    """The new conditional ResidualNet path (initial-layer concat + per-
    block GLU gate) against the fork's resnet.py:48-49, 72-77, fp64."""
    _import_fork()
    from normflows.nets import ResidualNet as TorchResidualNet

    from flowstate.flows.nets import ResidualNet

    d_in, d_out, hidden, ctx, blocks = 6, 10, 12, 3, 2
    torch.manual_seed(11)
    tnet = TorchResidualNet(d_in, d_out, hidden, context_features=ctx,
                            num_blocks=blocks).double().eval()
    jnet = ResidualNet(in_features=d_in, out_features=d_out,
                       hidden_features=hidden, num_blocks=blocks,
                       context_features=ctx)

    x = rng.normal(size=(23, d_in)).astype(np.float64)
    c = rng.normal(size=(23, ctx)).astype(np.float64)
    with jax.enable_x64(True):
        params = _transplant_resnet(tnet)
        with torch.no_grad():
            out_t = tnet(torch.tensor(x), context=torch.tensor(c))
        out_j = jnet.apply(params, jnp.asarray(x), context=jnp.asarray(c))
        np.testing.assert_allclose(np.asarray(out_j), out_t.numpy(),
                                   atol=1e-8)


def test_conditional_spline_flow_trains_on_toy_target(rng):
    """ConditionalNormalizingFlow with context-gated RQS couplings learns a
    context-dependent torus density (VERDICT r2 'done' criterion for the
    context gap: train on a toy conditional target)."""
    import optax

    from flowstate.flows import ConditionalNormalizingFlow
    from flowstate.flows.coupling import CircularSplineCoupling
    from flowstate.flows.distributions import UniformParticle

    d, ctx_dim, bound = 4, 2, 1.0

    class _CtxUniform:
        inner = UniformParticle(2, 2, bound)

        def log_prob(self, z, context=None):
            return self.inner.log_prob(z)

        def sample(self, key, n, context=None):
            return self.inner.sample(key, n)

    layers = tuple(
        CircularSplineCoupling(
            features=d, num_blocks=1, hidden_units=24,
            ind_circ=tuple(range(d)), num_bins=6, tail_bound=bound,
            context_features=ctx_dim, reverse_mask=bool(i % 2))
        for i in range(2))
    model = ConditionalNormalizingFlow(_CtxUniform(), layers)
    params = model.init_params(jax.random.key(0))

    # toy conditional target: wrapped Gaussian centered at -0.5 (ctx [1,0])
    # or +0.5 (ctx [0,1]) in every coordinate
    def make_batch(key, n):
        kc, kx = jax.random.split(key)
        label = jax.random.bernoulli(kc, 0.5, (n,))
        center = jnp.where(label, 0.5, -0.5)[:, None]
        x = center + 0.15 * jax.random.normal(kx, (n, d))
        x = (x + bound) % (2 * bound) - bound  # wrap onto the torus
        ctx = jnp.stack([1.0 - label, label.astype(jnp.float32)], axis=-1)
        return x, ctx

    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        x, ctx = make_batch(key, 256)
        loss, grads = jax.value_and_grad(model.forward_kld)(params, x, ctx)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.key(1)
    losses = []
    for i in range(250):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])

    # matched context must be far more likely than mismatched
    x, ctx = make_batch(jax.random.key(2), 512)
    lp_match = model.log_prob(params, x, ctx)
    lp_mismatch = model.log_prob(params, x, 1.0 - ctx)
    assert float(jnp.mean(lp_match - lp_mismatch)) > 1.0

    # round-trip + log-det antisymmetry with context
    z = jax.random.uniform(jax.random.key(3), (16, d), minval=-bound,
                           maxval=bound)
    y, ld = model.forward_and_log_det(params, z, context=ctx[:16])
    z_back, ld_inv = model.inverse_and_log_det(params, y, context=ctx[:16])
    np.testing.assert_allclose(np.asarray(z_back), np.asarray(z), atol=2e-4)
    np.testing.assert_allclose(np.asarray(ld + ld_inv), 0.0, atol=2e-4)

    # conditional sampling lands in the right mode
    s = model.sample(params, jax.random.key(4), 256,
                     context=jnp.tile(jnp.asarray([[0.0, 1.0]]), (256, 1)))
    assert float(jnp.mean(jnp.abs(s - 0.5) < 0.4)) > 0.8
