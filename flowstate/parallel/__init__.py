"""Device mesh / sharding / multi-host utilities."""

from flowstate.parallel.mesh import (
    CHAIN_AXIS,
    all_gather_samples,
    chain_sharding,
    initialize_distributed,
    make_chain_mesh,
    make_data_parallel_train_step,
    psum_counter,
    replicate,
    replicated_sharding,
    shard_batch,
    shard_chain_state,
    sharded_chain_fn,
)

__all__ = [
    "CHAIN_AXIS", "make_chain_mesh", "chain_sharding", "replicated_sharding",
    "shard_chain_state", "shard_batch", "replicate", "sharded_chain_fn",
    "make_data_parallel_train_step", "psum_counter", "all_gather_samples",
    "initialize_distributed",
]
