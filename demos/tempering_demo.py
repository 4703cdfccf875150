"""Parallel-tempering demo — capability the reference lacks.

Small-scale replica exchange on the 3-particle LJ double-well: every walker
starts with all particles in well A (a state plain beta=1 MCMC never
leaves), and the cold replica recovers the exact free-energy difference via
thermal crossings at the hot end of the ladder.  Full-scale version:
tools/tempering_check.py (TEMPERING.md).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis import classify_particles
from flowstate.mcmc import (
    init_tempered_state, run_replica_exchange, temperature_ladder,
)
from flowstate.ops import Box, SystemSpec


def main(smoke=False):
    # smoke=True: CI-scale run (seconds on CPU) exercising the same path
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    betas = temperature_ladder(1.0, 10.0, 8)

    base = np.array([[lx / 4, ly / 2], [lx / 4 + 1.1, ly / 2],
                     [lx / 4 - 0.6, ly / 2 + 0.9]], dtype=np.float32)
    walkers = 8 if smoke else 64
    pos = np.tile(base, (8, walkers, 1, 1))  # replicas x walkers, all in A
    state = init_tempered_state(spec, jnp.asarray(pos), jax.random.key(0),
                                0.65)

    rounds = 80 if smoke else 800
    run = jax.jit(lambda s, k: run_replica_exchange(
        spec, betas, s, k, num_rounds=rounds,
        moves_per_round=10 if smoke else 50))
    result = run(state, jax.random.key(1))

    cold = np.asarray(jax.device_get(result.cold_positions))[rounds * 3
                                                             // 8:]
    labels = classify_particles(cold.reshape(-1, 3, 2), lx / 2, r0=spec.r0)
    all_a = np.all(labels == 0, axis=-1).sum()
    all_b = np.all(labels == 1, axis=-1).sum()
    df = np.log(max(all_b, 1) / max(all_a, 1))
    print(f"edge swap acceptance: "
          f"{np.asarray(result.edge_acceptance).round(3).tolist()}")
    print(f"cold-replica dF = {df:.3f}  (exact quadrature: 1.490)")
    return df


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
