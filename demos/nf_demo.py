"""NF demo — script equivalent of the reference's demos/NF_demo.ipynb.

Trains a small circular-spline flow on the TwoMoons-like torus data
produced by a short MCMC run and visualizes the learned density.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis.plots import plot_frequency_heatmap, plot_loss
from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    init_alternating_wells, init_chain_state, run_moves_batch,
    run_production_batch,
)
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig, train


def main(smoke=False):
    # smoke=True: CI-scale run (seconds on CPU) exercising the same path
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    pos, _ = init_alternating_wells(10, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0), 0.65)
    state = run_moves_batch(spec, 1.0, state, 500 if smoke else 5000)
    state, obs = run_production_batch(spec, 1.0, state,
                                      128 if smoke else 1024, 10)
    data = (np.asarray(obs.positions).reshape(-1, 3, 2) - 5.0
            ).reshape(-1, 6).astype(np.float32)

    if smoke:
        model = build_circular_flow(3, 2, 5.0, K=3, hidden_units=32,
                                    num_bins=6)
        config = TrainConfig(batch_size=128, epochs=3, lr=1e-3)
    else:
        model = build_circular_flow(3, 2, 5.0, K=6, hidden_units=64,
                                    num_bins=8)
        config = TrainConfig(batch_size=256, epochs=20, lr=1e-3)
    params = model.init_params(jax.random.key(1))
    params, _, _, loss_epoch = train(model, params, jnp.asarray(data),
                                     config, jax.random.key(2))
    plot_loss(loss_epoch, "demo_results/nf_demo")

    samples = np.asarray(model.sample(params, jax.random.key(3),
                                      2000 if smoke else 20000))
    plot_frequency_heatmap(samples.reshape(-1, 3, 2), "demo_results/nf_demo",
                           5.0)
    print("final loss:", loss_epoch[-1])
    return loss_epoch


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
