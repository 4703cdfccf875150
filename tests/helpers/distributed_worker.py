"""Worker process for the 2-process jax.distributed test.

Run as:  python distributed_worker.py <process_id> <coordinator_addr>

Exercises the multi-host bring-up path SURVEY.md §2.5 requires
(``parallel/mesh.py:initialize_distributed``) on the CPU backend with 2
virtual local devices per process (4 global): a cross-process psum and a
sharded Metropolis segment whose per-chain trajectories must match a
single-controller reference run bitwise.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def main() -> None:
    process_id = int(sys.argv[1])
    coordinator = sys.argv[2]
    num_processes = 2

    from flowstate.parallel.mesh import initialize_distributed

    initialize_distributed(coordinator_address=coordinator,
                           num_processes=num_processes,
                           process_id=process_id)
    assert jax.process_count() == num_processes, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == 4 and n_local == 2, (n_global, n_local)

    mesh = Mesh(np.asarray(jax.devices()), ("chains",))
    sharding = NamedSharding(mesh, P("chains"))

    # --- 1) cross-process psum: global sum of a process-sharded array ----
    full = np.arange(8, dtype=np.float32)
    local = full[process_id * 4:(process_id + 1) * 4]
    arr = jax.make_array_from_process_local_data(sharding, local, (8,))
    total = jax.jit(jnp.sum,
                    out_shardings=NamedSharding(mesh, P()))(arr)
    got = float(jax.device_get(total))
    assert got == float(full.sum()), got

    # --- 2) sharded Metropolis segment vs single-controller reference ----
    from flowstate.mcmc import (
        init_alternating_wells, init_chain_state, run_moves,
    )
    from flowstate.ops import Box, SystemSpec

    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    c, moves = 8, 50
    positions, _ = init_alternating_wells(c, 3, 0.03)
    ref_state = init_chain_state(spec, jnp.asarray(positions),
                                 jax.random.key(0), 0.65)

    # single-controller reference: all chains on one device
    step = jax.vmap(lambda s: run_moves(spec, 1.0, s, moves))
    ref_out = jax.device_get(step(ref_state).positions)

    # distributed run: each process contributes its local chain shard
    def shard_leaf(leaf):
        is_key = jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key)
        raw = np.asarray(jax.random.key_data(leaf) if is_key else leaf)
        local_rows = raw[process_id * 4:(process_id + 1) * 4]
        arr = jax.make_array_from_process_local_data(sharding, local_rows,
                                                     raw.shape)
        return jax.random.wrap_key_data(arr) if is_key else arr

    dist_state = jax.tree_util.tree_map(shard_leaf, ref_state)
    dist_out = jax.jit(step)(dist_state)

    # per-chain trajectories are key-deterministic: local shards must
    # match the reference bitwise
    local_pos = np.concatenate(
        [np.asarray(s.data) for s in
         sorted(dist_out.positions.addressable_shards,
                key=lambda s: s.index[0].start)])
    expected = ref_out[process_id * 4:(process_id + 1) * 4]
    np.testing.assert_array_equal(local_pos, expected)

    # global acceptance counter psum across processes
    acc_total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(
        dist_out.attempts)
    assert int(jax.device_get(acc_total)) == c * moves

    print(f"worker {process_id} OK", flush=True)


if __name__ == "__main__":
    main()
