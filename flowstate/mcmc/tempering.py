"""Parallel tempering (replica exchange) for the batched Metropolis engine.

Capability extension beyond the reference (which has no tempering; its only
rare-event machinery is the NF big move, ``MCMC/monte_carlo.py:235-303``).
Replica exchange attacks the same double-well barrier problem from the
physics side: R replicas of every walker run at a ladder of temperatures,
and adjacent-temperature replicas periodically propose to exchange
configurations with the standard acceptance

    p_swap = min(1, exp((beta_i - beta_j) (E_i - E_j))),

which preserves the product distribution Π_r exp(-beta_r E) exactly.  Hot
replicas cross the barrier thermally; exchanges transport those crossings
down the ladder to the cold (target) replica.  Combined with the NF big
moves this gives two independent rare-event mechanisms that cross-validate
each other's ΔF.

Design
------
* State is one ``ChainState`` pytree with leading axes (R, W): R replicas
  (temperatures) × W walkers.  Local moves are the existing scan engine
  vmapped over both axes — the whole tempered ensemble advances as one
  device program; per-replica beta is a traced scalar in the move kernel.
* Swaps are branchless: each replica computes its partner index under the
  alternating even/odd pairing (deterministic-parity variant of DEO,
  Okabe et al. 2001), both members of a pair evaluate the same log-ratio
  and consume the same uniform (drawn at the pair's lower index), and the
  exchange is a ``jnp.where`` over a gather along the replica axis — no
  data-dependent control flow, one compiled program for both parities.
* Configurations and their cached energies/virials swap; the temperature
  slot keeps its own adapted max-displacement, counters, and PRNG key
  (displacement scale is a property of the temperature, not the walker).
* Multi-chip: shard the walker axis W exactly as the plain engine shards
  chains (``parallel/mesh.py``); the replica axis R is small (8-32) and
  stays on-chip.  If R is ever sharded instead, the partner gather becomes
  a ``jax.lax.ppermute`` by ±1 over the replica mesh axis — the exchange
  only ever touches nearest neighbours.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc.metropolis import run_moves
from flowstate.mcmc.state import ChainState, init_chain_state
from flowstate.ops.pair_energy import SystemSpec


def temperature_ladder(t_cold: float, t_hot: float, num_replicas: int,
                       kind: str = "geometric") -> jnp.ndarray:
    """Inverse-temperature ladder betas, shape (R,), betas[0] coldest.

    ``geometric`` (the standard choice — equal acceptance between neighbours
    for roughly constant heat capacity) or ``linear`` in T.
    """
    if num_replicas < 2:
        raise ValueError("need at least 2 replicas")
    if kind == "geometric":
        ts = t_cold * (t_hot / t_cold) ** (np.arange(num_replicas)
                                           / (num_replicas - 1))
    elif kind == "linear":
        ts = np.linspace(t_cold, t_hot, num_replicas)
    else:
        raise ValueError(f"unknown ladder kind {kind!r}")
    return jnp.asarray(1.0 / ts, dtype=jnp.float32)


def init_tempered_state(spec: SystemSpec, positions: jnp.ndarray,
                        key: jax.Array,
                        initial_max_displacement: float = 0.5) -> ChainState:
    """ChainState with leading axes (R, W) from positions (R, W, N, 2)."""
    r, w = positions.shape[:2]
    keys = jax.random.split(key, r)
    state = jax.vmap(
        lambda p, k: init_chain_state(spec, p, k, initial_max_displacement)
    )(positions, keys)
    return state


def run_tempered_moves(spec: SystemSpec, betas: jnp.ndarray,
                       state: ChainState, num_moves: int) -> ChainState:
    """Advance every replica by ``num_moves`` local moves at its own beta."""
    per_walker = lambda b, s: run_moves(spec, b, s, num_moves)
    per_replica = lambda b, s: jax.vmap(lambda x: per_walker(b, x))(s)
    return jax.vmap(per_replica)(betas, state)


class SwapResult(NamedTuple):
    state: ChainState
    accepted: jnp.ndarray      # (R, W) bool — True at BOTH members of a swap
    edge_attempted: jnp.ndarray  # (R,) bool — True at i iff edge i<->i+1
    #                              was attempted this sweep (lower members)


def swap_replicas(betas: jnp.ndarray, state: ChainState, key: jax.Array,
                  parity, u: jnp.ndarray = None) -> SwapResult:
    """One alternating-parity exchange sweep.

    ``parity`` 0 pairs (0,1), (2,3), …; parity 1 pairs (1,2), (3,4), …
    (ends unpaired).  May be a traced value — the partner map is pure jnp,
    so one compiled program serves both parities inside ``lax.scan``.

    ``u`` optionally supplies the (R, W) uniforms (the walker-sharded path
    precomputes a globally-consistent table; see ``run_replica_exchange``).
    """
    r, w = state.energy.shape
    idx = jnp.arange(r)
    lower = (idx - parity) % 2 == 0           # lower member of its pair
    partner = jnp.where(lower, idx + 1, idx - 1)
    valid = (partner >= 0) & (partner <= r - 1)
    partner = jnp.clip(partner, 0, r - 1)
    valid = valid & (partner != idx)

    d_beta = betas - betas[partner]                     # (R,)
    d_e = state.energy - state.energy[partner]          # (R, W)
    log_ratio = d_beta[:, None] * d_e                   # symmetric in pair

    # one uniform per pair: both members read the draw of the lower index
    if u is None:
        u = jax.random.uniform(key, (r, w))
    pair_low = jnp.minimum(idx, partner)
    u_pair = u[pair_low]
    accept = valid[:, None] & (jnp.log(u_pair) < log_ratio)

    take = lambda field: jnp.where(
        accept.reshape((r, w) + (1,) * (field.ndim - 2)),
        field[partner], field)
    new_state = state._replace(
        positions=take(state.positions),
        energy=take(state.energy),
        virial=take(state.virial),
    )
    return SwapResult(new_state, accept, lower & valid)


def swap_replicas_replica_sharded(betas: jnp.ndarray, state: ChainState,
                                  key: jax.Array, parity,
                                  axis_name: str) -> SwapResult:
    """Exchange sweep with the REPLICA axis sharded over a mesh axis.

    The one PT coupling that is not embarrassingly parallel: a swap partner
    can live on the neighbouring shard.  Exchanges only ever touch ladder
    neighbours, so the cross-shard traffic is two nearest-neighbour
    ``jax.lax.ppermute`` edge-row exchanges per field (cf. module
    docstring).  Call inside ``shard_map`` with the state's
    replica axis sharded over ``axis_name``; ``betas`` and ``key`` must be
    replicated (every shard draws the identical global uniform table, so
    the result is bit-identical to the unsharded ``swap_replicas``).
    """
    r_local, w = state.energy.shape
    n_shards = jax.lax.axis_size(axis_name)
    r_total = r_local * n_shards
    g0 = jax.lax.axis_index(axis_name) * r_local
    gi = g0 + jnp.arange(r_local)
    lower = (gi - parity) % 2 == 0
    partner_g = jnp.where(lower, gi + 1, gi - 1)
    valid = (partner_g >= 0) & (partner_g <= r_total - 1)
    partner_g = jnp.clip(partner_g, 0, r_total - 1)

    # ring permutations (static): my last row -> right neighbour, my first
    # row -> left neighbour; the wrap-around rows are masked off by `valid`
    right_perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left_perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    ext_idx = partner_g - g0 + 1  # index into [prev_last, local…, next_first]

    def partner_rows(field):
        prev_last = jax.lax.ppermute(field[-1], axis_name, right_perm)
        next_first = jax.lax.ppermute(field[0], axis_name, left_perm)
        ext = jnp.concatenate(
            [prev_last[None], field, next_first[None]], axis=0)
        return ext[ext_idx]

    d_beta = betas[gi] - betas[partner_g]                # (r_local,)
    d_e = state.energy - partner_rows(state.energy)      # (r_local, W)
    log_ratio = d_beta[:, None] * d_e

    # the same global uniform table on every shard; both pair members read
    # the lower index's draw (matches the unsharded swap_replicas exactly)
    u = jax.random.uniform(key, (r_total, w))
    u_pair = u[jnp.minimum(gi, partner_g)]
    accept = valid[:, None] & (jnp.log(u_pair) < log_ratio)

    take = lambda field: jnp.where(
        accept.reshape((r_local, w) + (1,) * (field.ndim - 2)),
        partner_rows(field), field)
    new_state = state._replace(
        positions=take(state.positions),
        energy=take(state.energy),
        virial=take(state.virial),
    )
    return SwapResult(new_state, accept, lower & valid)


class ReplicaExchangeResult(NamedTuple):
    state: ChainState
    # fraction of accepted swaps per ladder edge i <-> i+1, shape (R-1,)
    edge_acceptance: jnp.ndarray
    # trajectory recorded after every round:
    #   record='cold' -> cold replica only, (T, W, N, 2) / (T, W)
    #   record='all'  -> every replica (for MBAR pooling,
    #                    analysis/mbar.py), (T, R, W, N, 2) / (T, R, W)
    cold_positions: jnp.ndarray
    cold_energy: jnp.ndarray
    # per-round record_fn(state) outputs stacked over rounds (None when no
    # record_fn was given) — compute observables ON DEVICE instead of
    # shipping every replica's raw positions to the host
    extras: object


def run_replica_exchange(spec: SystemSpec, betas: jnp.ndarray,
                         state: ChainState, key: jax.Array,
                         num_rounds: int, moves_per_round: int,
                         record: str = "cold",
                         record_fn=None,
                         total_walkers: int = None,
                         walker_offset=0) -> ReplicaExchangeResult:
    """The full PT loop: {local moves at every temperature, one exchange
    sweep with alternating parity}, recording the sampled trajectory.

    ``record='cold'`` keeps only the target-temperature replica (the
    occupancy observable); ``record='all'`` keeps every replica so MBAR
    (``analysis/mbar.py``) can pool the whole ladder.  One ``lax.scan``
    over rounds — jit this whole function; wall-clock is the local moves
    (the swap is O(R·W) elementwise).

    Walker-sharded multi-chip path (the one PT coupling that is NOT
    embarrassingly parallel is the replica axis, which stays on-shard; the
    walker axis shards freely): inside ``shard_map`` pass the GLOBAL walker
    count as ``total_walkers`` and this shard's start index (``lax.
    axis_index(mesh_axis) * w_local``) as ``walker_offset`` — every shard
    then draws the same global swap-uniform table and slices its columns,
    so the sharded run is bit-identical to the single-device run.  The
    local moves already consume per-walker keys carried in ``ChainState``.
    """
    if record not in ("cold", "all"):
        raise ValueError(f"unknown record mode {record!r}")
    r = betas.shape[0]

    def body(carry, i):
        st, k = carry
        k, k_swap = jax.random.split(k)
        st = run_tempered_moves(spec, betas, st, moves_per_round)
        w_local = st.energy.shape[1]
        u_full = jax.random.uniform(
            k_swap, (r, total_walkers if total_walkers else w_local))
        u = jax.lax.dynamic_slice(
            u_full, (0, walker_offset if total_walkers else 0),
            (r, w_local))
        res = swap_replicas(betas, st, k_swap, parity=i % 2, u=u)
        # edge i <-> i+1 accounting at the lower member only — an upper
        # member's accepted flag belongs to the edge below it
        att = res.edge_attempted[:-1].astype(jnp.float32)
        acc = (jnp.mean(res.accepted.astype(jnp.float32), axis=1)[:-1]
               * att)
        if record == "all":
            rec = (res.state.positions, res.state.energy)
        else:
            rec = (res.state.positions[0], res.state.energy[0])
        extra = record_fn(res.state) if record_fn is not None else 0
        return (res.state, k), (acc, att) + rec + (extra,)

    (state, _), (acc, att, rec_pos, rec_e, extras) = jax.lax.scan(
        body, (state, key), jnp.arange(num_rounds))
    edge_acceptance = jnp.sum(acc, axis=0) / jnp.maximum(
        jnp.sum(att, axis=0), 1.0)
    return ReplicaExchangeResult(state, edge_acceptance, rec_pos, rec_e,
                                 extras if record_fn is not None else None)
