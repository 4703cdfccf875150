"""Chain state for the batched Metropolis engine.

The reference mutates a ``MonteCarlo`` object per move
(``MCMC/monte_carlo.py:11-144``); here the complete per-chain state is an
immutable pytree advanced by pure kernels, so the engine composes with
``jit`` / ``lax.scan`` / ``vmap`` / ``shard_map``.  The leading axis of every
leaf is the chains axis C when batched.

State fields mirror the reference's bookkeeping:
  positions            MonteCarlo.particles             (monte_carlo.py:64)
  energy / virial      EnergyCalculator.total_*          (energy_calculator.py:46)
  max_disp             MonteCarlo.max_displacement       (monte_carlo.py:76)
  attempts / accepts   attempts_/accepted_displacement   (monte_carlo.py:80-83)
  prev_*               previous_* counters for adaptive displacement
                       (monte_carlo.py:82-83)
  key                  per-chain jax PRNG key, replacing
                       ``np.random.default_rng(seed)`` (monte_carlo.py:92-95)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from flowstate.ops.pair_energy import SystemSpec, total_energy_virial


def batched_energy_virial(spec: SystemSpec, positions: jnp.ndarray,
                          chunk_elems: int = 2 ** 28):
    """Per-chain (energy, virial) for a (C, N, 2) batch, memory-safely.

    A plain ``vmap`` materialises the C x N x N pair intermediates at
    once — 16 GB of device memory at C=2048, N=1024.  When the pair tensor would exceed ``chunk_elems`` fp32
    elements (default ~1 GB), the batch is processed in chain chunks via
    ``lax.map`` (still one compiled program, still static shapes);
    results match the full vmap to fp32 reduction-order noise.
    """
    c, n = positions.shape[0], positions.shape[1]
    per_chain = max(n * n * 2, 1)  # fp32 elems in the pair diff tensor
    chunk = max(1, min(c, chunk_elems // per_chain))
    if chunk >= c:
        return jax.vmap(lambda p: total_energy_virial(spec, p))(positions)
    n_chunks = -(-c // chunk)
    pad = n_chunks * chunk - c
    if pad:
        positions = jnp.concatenate(
            [positions, jnp.broadcast_to(positions[-1:], (pad, n, 2))])
    e, v = jax.lax.map(
        lambda ps: jax.vmap(lambda p: total_energy_virial(spec, p))(ps),
        positions.reshape(n_chunks, chunk, n, 2))
    return e.reshape(-1)[:c], v.reshape(-1)[:c]


class ChainState(NamedTuple):
    positions: jnp.ndarray   # (..., N, 2)
    energy: jnp.ndarray      # (...,)
    virial: jnp.ndarray      # (...,)
    max_disp: jnp.ndarray    # (...,)
    attempts: jnp.ndarray    # (...,) int32
    accepts: jnp.ndarray     # (...,) int32
    prev_attempts: jnp.ndarray  # (...,) int32
    prev_accepts: jnp.ndarray   # (...,) int32
    key: jax.Array           # per-chain PRNG key (batched typed key array)


def init_chain_state(spec: SystemSpec, positions: jnp.ndarray,
                     key: jax.Array,
                     initial_max_displacement: float = 0.5) -> ChainState:
    """Build the state for a batch of chains.

    Args:
      positions: (C, N, 2) initial configurations (or (N, 2) for one chain).
      key: a single PRNG key; split per chain.
    """
    single = positions.ndim == 2
    if single:
        positions = positions[None]
    c = positions.shape[0]
    keys = jax.random.split(key, c)
    energy, virial = batched_energy_virial(spec, positions)
    zeros_i = jnp.zeros((c,), dtype=jnp.int32)
    state = ChainState(
        positions=positions.astype(jnp.float32),
        energy=energy.astype(jnp.float32),
        virial=virial.astype(jnp.float32),
        max_disp=jnp.full((c,), initial_max_displacement, dtype=jnp.float32),
        attempts=zeros_i,
        accepts=zeros_i,
        prev_attempts=zeros_i,
        prev_accepts=zeros_i,
        key=keys,
    )
    if single:
        state = jax.tree_util.tree_map(lambda x: x[0], state)
    return state


def resync_energy(spec: SystemSpec, state: ChainState) -> ChainState:
    """Recompute cached totals from positions (guards fp32 drift over long
    delta-update runs; the reference's analogue is the full recompute in
    ``nf_big_move``'s reject path, monte_carlo.py:301)."""
    if state.positions.ndim == 3:
        energy, virial = batched_energy_virial(spec, state.positions)
    else:
        energy, virial = total_energy_virial(spec, state.positions)
    return state._replace(energy=energy.astype(state.energy.dtype),
                          virial=virial.astype(state.virial.dtype))
