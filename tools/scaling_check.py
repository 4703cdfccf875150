"""Multi-device scaling measurement on the virtual CPU mesh.

Measures chain-throughput scaling 1 -> N devices (the BASELINE.md north
star: >= 85% efficiency) for the sharded Metropolis engine and the
data-parallel training step.  Runs on the 8-device virtual CPU backend so
it exercises the real shard_map/psum code paths (wall-clock numbers are CPU
numbers; the sharding structure is the one the GPUs run).

Usage: JAX_PLATFORMS=cpu python tools/scaling_check.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def measure_mcmc(n_devices: int, chains_per_device: int = 512,
                 moves: int = 200) -> float:
    from flowstate.mcmc import (
        init_alternating_wells, init_chain_state, run_moves_batch,
    )
    from flowstate.ops import Box, SystemSpec
    from flowstate.parallel import (
        make_chain_mesh, shard_chain_state, sharded_chain_fn,
    )

    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    c = n_devices * chains_per_device
    pos, _ = init_alternating_wells(c, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0), 0.65)
    mesh = make_chain_mesh(n_devices=n_devices)
    state = shard_chain_state(state, mesh)
    fn = jax.jit(sharded_chain_fn(
        lambda s: run_moves_batch(spec, 1.0, s, moves), mesh))
    s = fn(state)
    jax.block_until_ready(s.energy)
    t0 = time.perf_counter()
    for _ in range(3):
        s = fn(s)
    jax.block_until_ready(s.energy)
    dt = (time.perf_counter() - t0) / 3
    return c * moves / dt


def measure_training(n_devices: int, batch_per_device: int = 128,
                     steps: int = 5) -> float:
    from flowstate.flows import build_circular_flow
    from flowstate.parallel import (
        make_chain_mesh, make_data_parallel_train_step, shard_batch,
    )
    from flowstate.training import TrainConfig, TrainState, make_optimizer

    model = build_circular_flow(3, 2, 5.0, K=4, hidden_units=64, num_bins=8)
    params = model.init_params(jax.random.key(0))
    config = TrainConfig(batch_size=n_devices * batch_per_device, epochs=1,
                         lr=1e-4)
    optimizer = make_optimizer(config)
    mesh = make_chain_mesh(n_devices=n_devices)
    step = make_data_parallel_train_step(model, config, optimizer, mesh)
    batch = shard_batch(
        jax.random.uniform(jax.random.key(1),
                           (config.batch_size, 6), minval=-5.0, maxval=5.0),
        mesh)
    st = TrainState(params, optimizer.init(params), jax.random.key(2))
    st, loss = step(st, batch)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        st, loss = step(st, batch)
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / steps
    return config.batch_size / dt


def main() -> None:
    device_counts = [1, 2, 4, 8]
    lines = ["# SCALING — multi-device efficiency (virtual 8-CPU mesh)\n",
             "Weak scaling: per-device work fixed, devices swept; efficiency",
             "= throughput(N) / (N * throughput(1)).  Structure identical to",
             "the multi-GPU mesh (shard_map over Mesh(('chains',)) + psum).\n"]

    lines.append("## Metropolis engine (chains axis)\n")
    lines.append("| devices | chains | moves/s | efficiency |")
    lines.append("|---|---|---|---|")
    base = None
    for n in device_counts:
        thr = measure_mcmc(n)
        if base is None:
            base = thr
        eff = thr / (n * base)
        lines.append(f"| {n} | {n * 512} | {thr:,.0f} | {eff:.2%} |")
        print(lines[-1], flush=True)

    lines.append("\n## Data-parallel flow training (batch axis, psum grads)\n")
    lines.append("| devices | global batch | samples/s | efficiency |")
    lines.append("|---|---|---|---|")
    base = None
    for n in device_counts:
        thr = measure_training(n)
        if base is None:
            base = thr
        eff = thr / (n * base)
        lines.append(f"| {n} | {n * 128} | {thr:,.0f} | {eff:.2%} |")
        print(lines[-1], flush=True)

    with open("SCALING.md", "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote SCALING.md")


if __name__ == "__main__":
    main()
