"""Batched NVT Metropolis engine: pure kernels over ChainState.

Re-design of the reference's serial move loop
(``MCMC/monte_carlo.py``):

* ``metropolis_move``        — one single-particle displacement attempt
  (``particle_displacement`` monte_carlo.py:146-189 +
  ``metropolis_acceptance_particle_move`` :191-223), branchless.
* ``run_moves``              — ``lax.fori_loop`` over moves within a chain.
* ``run_production``         — ``lax.scan`` over sampling blocks emitting
  observables at the reference's sampling stride (``sample``
  monte_carlo.py:416-444), entirely on device.
* ``adjust_displacement``    — adaptive max displacement targeting a 0.5
  acceptance ratio, factor clamped to [0.5, 1.5]
  (``adjust_displacement`` monte_carlo.py:375-403).
* ``run_equilibration``      — moves + periodic adjustment
  (driver loops like main_algorithm_1.py:203-210).

Throughput comes from chain vectorization: every kernel is written for one
chain and lifted with ``vmap`` over a leading chains axis (and ``shard_map``
over a device mesh, see ``flowstate.parallel``).  Moves within a chain
are inherently sequential (Markov property) and stay in a scan.

The hard-core ``inf`` energies follow reference semantics: a proposed overlap
gives ``delta_e = +inf``, ``exp(-beta*inf) == 0`` and the move is rejected
(monte_carlo.py:204-210); cached totals are only updated on accept so they
stay finite for any valid state.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from flowstate.mcmc.state import ChainState
from flowstate.ops.box import wrap_pbc
from flowstate.ops.pair_energy import (
    SystemSpec, particle_energy_virial, pressure,
)


def _apply_move(spec: SystemSpec, beta: float, state: ChainState,
                p: jnp.ndarray, disp_unit: jnp.ndarray,
                u: jnp.ndarray) -> ChainState:
    """Core Metropolis update given pre-drawn randoms.

    p: particle index, disp_unit: uniform [0,1)^2, u: acceptance uniform.
    """
    eno, viro = particle_energy_virial(spec, state.positions, p)

    disp = (disp_unit - 0.5) * state.max_disp
    # One-hot select/update instead of dynamic gather/scatter: a masked
    # where over the (tiny) particle axis fuses with the rest of the move
    # (whether a gather is cheaper on the GPU is ROADMAP S2).
    onehot = (jnp.arange(spec.num_particles) == p)[:, None]  # (N, 1)
    old_p = jnp.sum(jnp.where(onehot, state.positions, 0.0), axis=0)  # (2,)
    moved = wrap_pbc(old_p + disp, spec.box)
    new_positions = jnp.where(onehot, moved[None, :], state.positions)
    enn, virn = particle_energy_virial(spec, new_positions, p)

    delta_e = enn - eno
    delta_v = virn - viro

    # Metropolis: accept if dE <= 0, else with prob exp(-beta dE); an inf
    # new energy gives exp(-inf) = 0 -> certain rejection.
    accept = (delta_e <= 0.0) | (u < jnp.exp(-beta * delta_e))

    zero_e = jnp.zeros_like(delta_e)
    return state._replace(
        positions=jnp.where(accept, new_positions, state.positions),
        energy=state.energy + jnp.where(accept, delta_e, zero_e),
        virial=state.virial + jnp.where(accept, delta_v, zero_e),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.astype(state.accepts.dtype),
    )


def metropolis_move(spec: SystemSpec, beta: float,
                    state: ChainState) -> ChainState:
    """One displacement attempt for a single (unbatched) chain."""
    key, k_p, k_disp, k_acc = jax.random.split(state.key, 4)
    n = spec.num_particles
    p = jax.random.randint(k_p, (), 0, n)
    disp_unit = jax.random.uniform(k_disp, (2,), dtype=state.positions.dtype)
    u = jax.random.uniform(k_acc, (), dtype=state.energy.dtype)
    return _apply_move(spec, beta, state, p, disp_unit, u)._replace(key=key)


def _run_chunk(spec: SystemSpec, beta: float, state: ChainState,
               num_moves: int) -> ChainState:
    """A chunk of moves consuming pre-drawn random tables."""
    key, k_p, k_disp, k_acc = jax.random.split(state.key, 4)
    n = spec.num_particles
    p_tab = jax.random.randint(k_p, (num_moves,), 0, n)
    d_tab = jax.random.uniform(k_disp, (num_moves, 2),
                               dtype=state.positions.dtype)
    u_tab = jax.random.uniform(k_acc, (num_moves,), dtype=state.energy.dtype)

    def body(s, xs):
        p, d, u = xs
        return _apply_move(spec, beta, s, p, d, u), None

    state, _ = jax.lax.scan(body, state._replace(key=key),
                            (p_tab, d_tab, u_tab))
    return state


# Random tables are drawn per chunk of this many moves: large enough to
# amortize the threefry call, small enough that the batched (chains, chunk)
# tables stay a few MB.
RNG_CHUNK = 256


def run_moves(spec: SystemSpec, beta: float, state: ChainState,
              num_moves: int) -> ChainState:
    """``num_moves`` sequential attempts on one chain.

    Drawing randoms *inside* the move loop makes the threefry key schedule
    the bottleneck.  Instead random tables — particle indices (T,), unit
    displacements (T, 2), acceptance uniforms (T,) — are generated in three
    batched draws per RNG_CHUNK of moves and the scan consumes rows.
    Statistically identical (same counter-based PRNG stream).
    """
    full_chunks, remainder = divmod(num_moves, RNG_CHUNK)
    if full_chunks > 0:
        state = jax.lax.fori_loop(
            0, full_chunks,
            lambda _, s: _run_chunk(spec, beta, s, RNG_CHUNK), state)
    if remainder > 0:
        state = _run_chunk(spec, beta, state, remainder)
    return state


def adjust_displacement(state: ChainState,
                        target_acceptance: float = 0.5) -> ChainState:
    """Adaptive max-displacement update; reference monte_carlo.py:375-403.

    factor = block acceptance fraction / target, clamped to [0.5, 1.5];
    no-op when no attempts happened since the previous adjustment.
    """
    delta_att = state.attempts - state.prev_attempts
    delta_acc = state.accepts - state.prev_accepts
    any_attempts = delta_att > 0
    frac = jnp.where(any_attempts,
                     delta_acc / jnp.maximum(delta_att, 1).astype(jnp.float32),
                     0.0)
    factor = jnp.clip(frac / target_acceptance, 0.5, 1.5)
    new_disp = jnp.where(any_attempts, state.max_disp * factor,
                         state.max_disp)
    return state._replace(
        max_disp=new_disp,
        prev_attempts=jnp.where(any_attempts, state.attempts,
                                state.prev_attempts),
        prev_accepts=jnp.where(any_attempts, state.accepts,
                               state.prev_accepts),
    )


class Observables(NamedTuple):
    """One observable sample; reference ``MonteCarlo.sample``
    (monte_carlo.py:416-444) returns the same tuple fields."""

    cycle: jnp.ndarray
    energy_per_particle: jnp.ndarray
    density: jnp.ndarray
    pressure: jnp.ndarray
    box_size_x: jnp.ndarray
    box_size_y: jnp.ndarray
    positions: jnp.ndarray  # (N, 2)


def sample_observables(spec: SystemSpec, beta: float, state: ChainState,
                       cycle) -> Observables:
    volume = spec.box.volume
    density = spec.num_particles / volume
    return Observables(
        cycle=jnp.asarray(cycle, dtype=jnp.int32),
        energy_per_particle=state.energy / spec.num_particles,
        density=jnp.full_like(state.energy, density),
        pressure=pressure(spec, state.virial, beta),
        box_size_x=jnp.full_like(state.energy, spec.box.size_x),
        box_size_y=jnp.full_like(state.energy, spec.box.size_y),
        positions=state.positions,
    )


def run_production(spec: SystemSpec, beta: float, state: ChainState,
                   num_samples: int, sampling_frequency: int,
                   start_cycle: int = 0) -> Tuple[ChainState, Observables]:
    """Production run on one chain: scan over ``num_samples`` blocks of
    ``sampling_frequency`` moves, emitting one observable per block.

    Equivalent to the reference production loops
    (main.py:168-177, main_algorithm_1.py:244-251) but fully on device:
    the sample buffers come back as stacked arrays (num_samples, ...).
    ``start_cycle`` continues the cycle numbering across phases (the
    reference counts cycles over the whole run).
    """

    def block(carry, i):
        s = run_moves(spec, beta, carry, sampling_frequency)
        obs = sample_observables(spec, beta, s,
                                 start_cycle + (i + 1) * sampling_frequency)
        return s, obs

    return jax.lax.scan(block, state, jnp.arange(num_samples))


def run_production_with(spec: SystemSpec, beta: float, state: ChainState,
                        num_samples: int, sampling_frequency: int, move_fn,
                        start_cycle: int = 0) -> Tuple[ChainState, Observables]:
    """``run_production`` with a pluggable per-block move kernel.

    ``move_fn(state, num_moves) -> state`` advances one chain by one
    sampling block; passing ``run_moves``/``run_mala``/``run_hmc``
    partials yields the same observable stream from any sampler (the
    reference's production loop, main.py:168-177, is Metropolis-only —
    the drift/trajectory samplers are beyond-reference capability).
    """

    def block(carry, i):
        s = move_fn(carry, sampling_frequency)
        obs = sample_observables(spec, beta, s,
                                 start_cycle + (i + 1) * sampling_frequency)
        return s, obs

    return jax.lax.scan(block, state, jnp.arange(num_samples))


def run_equilibration(spec: SystemSpec, beta: float, state: ChainState,
                      num_steps: int, adjusting_frequency: int,
                      target_acceptance: float = 0.5) -> ChainState:
    """Equilibration with periodic displacement adaptation.

    Mirrors the driver loop main_algorithm_1.py:203-207: every
    ``adjusting_frequency`` moves, adapt; remainder moves run after the
    last full block.  Adaptation only runs during equilibration, preserving
    detailed balance in production (SURVEY.md §7.2).
    """
    num_blocks = num_steps // adjusting_frequency
    remainder = num_steps - num_blocks * adjusting_frequency

    def block(carry, _):
        s = run_moves(spec, beta, carry, adjusting_frequency)
        s = adjust_displacement(s, target_acceptance)
        return s, None

    if num_blocks > 0:
        state, _ = jax.lax.scan(block, state, None, length=num_blocks)
    if remainder > 0:
        state = run_moves(spec, beta, state, remainder)
    return state


# ----------------------------------------------------------------------
# Batched (many chains) frontends: vmap over the chains axis.
# ----------------------------------------------------------------------

def batched(fn, spec: SystemSpec, beta: float, **static_kwargs):
    """Lift a single-chain kernel to a batch of chains via vmap."""
    return jax.vmap(functools.partial(fn, spec, beta, **static_kwargs))


def run_equilibration_batch(spec, beta, state, num_steps,
                            adjusting_frequency, target_acceptance=0.5):
    return jax.vmap(lambda s: run_equilibration(
        spec, beta, s, num_steps, adjusting_frequency,
        target_acceptance))(state)


def run_production_batch(spec, beta, state, num_samples, sampling_frequency,
                         start_cycle: int = 0):
    """Returns (state, observables) with observables leaves shaped
    (C, num_samples, ...)."""
    return jax.vmap(lambda s: run_production(
        spec, beta, s, num_samples, sampling_frequency, start_cycle))(state)


def run_moves_batch(spec, beta, state, num_moves):
    return jax.vmap(lambda s: run_moves(spec, beta, s, num_moves))(state)


def run_production_with_batch(spec, beta, state, num_samples,
                              sampling_frequency, move_fn,
                              start_cycle: int = 0):
    """Batched ``run_production_with``: observables leaves (C, T, ...)."""
    return jax.vmap(lambda s: run_production_with(
        spec, beta, s, num_samples, sampling_frequency, move_fn,
        start_cycle))(state)
