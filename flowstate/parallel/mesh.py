"""Device mesh + sharding utilities: the multi-chip scaling layer.

The reference has **no** distributed runtime (SURVEY.md §2.5): its "100
parallel chains" are a sequential Python loop and its only multi-process
story is share-nothing subprocesses joined through a file lock.  Here the
scaling axes are explicit:

* chains axis  — ``ChainState`` leaves sharded on axis 0 over a 1-D
  ``Mesh(('chains',))``; the Metropolis kernels are embarrassingly parallel
  per chain, so ``shard_map`` adds zero communication.
* data axis    — flow training batches sharded over the same devices; flow
  params stay replicated (the model is ~10^5-10^6 params, SURVEY.md §2.5)
  and gradients are combined with ``psum`` (NCCL over NVLink on GPUs).

Multi-host: call ``initialize_distributed()`` once per process, then every
helper below works on the global device set.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

CHAIN_AXIS = "chains"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (``jax.distributed.initialize`` wrapper)."""
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_chain_mesh(devices: Optional[Sequence[Any]] = None,
                    n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the chains axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (CHAIN_AXIS,))


def chain_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (chains) of a pytree leaf across the mesh."""
    return NamedSharding(mesh, P(CHAIN_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chain_state(state, mesh: Mesh):
    """Place every leaf of a batched ChainState with chains sharded."""
    sharding = chain_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), state)


def shard_batch(batch: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    return jax.device_put(batch, chain_sharding(mesh))


def replicate(pytree, mesh: Mesh):
    sharding = replicated_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), pytree)


def sharded_chain_fn(fn, mesh: Mesh):
    """Lift a batched chain kernel (C-leading pytrees -> C-leading pytrees)
    to a sharded kernel over the chains mesh axis.

    The kernel must be pure elementwise-per-chain (no cross-chain reduction)
    — true for every Metropolis kernel — so ``shard_map`` needs no
    collectives and XLA overlaps nothing but the final fan-in.
    """
    return shard_map(fn, mesh=mesh, in_specs=P(CHAIN_AXIS),
                     out_specs=P(CHAIN_AXIS))


def make_data_parallel_train_step(model, config, optimizer, mesh: Mesh):
    """Explicit-collective data-parallel training step.

    Per-shard loss/grads on the local batch shard, ``psum``-averaged over
    the mesh, identical optimizer update computed on every device
    (params replicated).  Returns ``step(train_state, global_batch)``.

    (A plain ``jax.jit`` with sharded batch + replicated params compiles to
    the same collective; this version makes the communication explicit and
    testable, cf. SNIPPETS.md pattern [1].)
    """
    from flowstate.training.train import TrainState

    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

    def shard_step(params, opt_state, key, batch_shard):
        # decorrelate shards: the replicated key is folded with the shard
        # index so reverse-KLD base draws differ per device
        key = jax.random.fold_in(key, jax.lax.axis_index(CHAIN_AXIS))

        def loss_fn(p):
            loss = 0.0
            if config.alpha > 0.0:
                loss = loss + config.alpha * model.forward_kld(p, batch_shard)
            if config.alpha < 1.0:
                rkld, _ = model.reverse_kld(
                    p, key, config.reverse_num_samples // n_shards)
                loss = loss + (1.0 - config.alpha) * rkld
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.pmean(loss, CHAIN_AXIS)
        grads = jax.lax.pmean(grads, CHAIN_AXIS)
        finite = jnp.isfinite(loss)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(finite, jnp.nan_to_num(g),
                                jnp.zeros_like(g)), grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(
            lambda u: jnp.where(finite, u, jnp.zeros_like(u)), updates)
        import optax
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    sharded = shard_map(
        shard_step, mesh=mesh,
        in_specs=(P(), P(), P(), P(CHAIN_AXIS)),
        out_specs=(P(), P(), P()))

    @jax.jit
    def step(state: "TrainState", batch: jnp.ndarray):
        key, k_loss = jax.random.split(state.key)
        params, opt_state, loss = sharded(state.params, state.opt_state,
                                          k_loss, batch)
        return TrainState(params, opt_state, key), loss

    return step


def psum_counter(value: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """All-reduce a per-shard counter over the chains mesh (e.g. acceptance
    counts, well-state histogram bins)."""
    fn = shard_map(lambda v: jax.lax.psum(jnp.sum(v), CHAIN_AXIS),
                   mesh=mesh, in_specs=P(CHAIN_AXIS), out_specs=P(),
                   check_vma=False)
    return fn(value)


def all_gather_samples(samples: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Pool per-shard sample buffers to every device (training-set pooling,
    SURVEY.md §7.6)."""
    fn = shard_map(
        lambda s: jax.lax.all_gather(s, CHAIN_AXIS, axis=0, tiled=True),
        mesh=mesh, in_specs=P(CHAIN_AXIS), out_specs=P(),
        check_vma=False)
    return fn(samples)
