"""HMC: multi-step Hamiltonian whole-configuration moves (beyond-reference).

Hamiltonian Monte Carlo generalises MALA (``mcmc/mala.py``): draw
momenta ``p ~ N(0, I)``, integrate the Hamiltonian ``H(x, p) =
beta U(x) + |p|^2 / 2`` for ``num_leapfrog`` leapfrog steps of size
``eps``, and Metropolis-accept on ``exp(-dH)``.  A single leapfrog step
with ``eps = sqrt(2 tau)`` IS the MALA proposal; longer trajectories
suppress the random-walk behaviour that limits both the displacement
engine and MALA between LJ clashes.

Like MALA this is a capability the reference cannot express: its numpy
physics defines ``lennard_jones_force`` but never calls it
(``MCMC/potential.py:38-46``, noted unused in SURVEY.md §2.1).  Here the
drift comes from ``jax.grad`` of the SAME differentiable energy the
Metropolis engine samples (``ops/pair_energy.py``) — one physics
implementation, three gradient samplers.

Design notes (mirroring ``mcmc/mala.py``):

* The per-chain leapfrog step size ``eps`` lives in
  ``ChainState.max_disp`` (same adaptation machinery; target acceptance
  0.65, the HMC optimum of Beskos et al. 2013).
* ``num_leapfrog`` is static (compiled into the program) — the
  trajectory is a ``lax.scan`` of full kicks with the boundary
  half-kicks folded in, so one compiled program serves every chain.
* Positions wrap into the box after every drift; on the torus the
  wrap commutes with the dynamics (momenta and ``U`` are unchanged), so
  the integrator stays exactly volume-preserving and time-reversible
  and detailed balance is exact — no wrapped-Gaussian approximation is
  needed at all (an advantage over MALA's proposal-density term).
* A trajectory that lands in the hard core has ``U = +inf`` so
  ``exp(-dH) = 0`` and the move is rejected in place
  (``energy_calculator.py:73-76`` semantics); non-finite gradients along
  the way are zeroed by ``potential_gradient`` so positions never go
  NaN.
* Energies/virials are recomputed exactly on every move (whole-config
  proposals make the O(N^2) recompute the natural cost) — tracked
  totals never drift.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flowstate.mcmc.mala import potential_gradient
from flowstate.mcmc.state import ChainState
from flowstate.ops.box import wrap_pbc
from flowstate.ops.pair_energy import SystemSpec, total_energy_virial

HMC_TARGET_ACCEPTANCE = 0.65  # optimal HMC acceptance (Beskos et al. 2013)
DEFAULT_NUM_LEAPFROG = 10


def _hmc_apply(spec: SystemSpec, beta: float, state: ChainState,
               p0: jnp.ndarray, u: jnp.ndarray,
               num_leapfrog: int) -> ChainState:
    """One HMC update for a single chain given pre-drawn randoms.

    p0: (N, 2) standard-normal momenta; u: acceptance uniform.
    """
    x0 = state.positions
    eps = state.max_disp

    # Leapfrog: initial half kick, then a scan of (drift, full kick);
    # the trailing half kick is recovered by undoing half of the last
    # full kick — algebraically identical to the textbook splitting.
    p = p0 - 0.5 * eps * beta * potential_gradient(spec, x0)

    def step(carry, _):
        x, p = carry
        x = wrap_pbc(x + eps * p, spec.box)
        g = potential_gradient(spec, x)
        p = p - eps * beta * g
        return (x, p), g

    (x, p), gs = jax.lax.scan(step, (x0, p), None, length=num_leapfrog)
    p = p + 0.5 * eps * beta * gs[-1]

    e_new, vir_new = total_energy_virial(spec, x)

    # dH = beta dU + dK; an inf proposal energy gives -inf -> exp 0 ->
    # reject (branchless, like the displacement engine)
    d_kinetic = 0.5 * (jnp.sum(p * p) - jnp.sum(p0 * p0))
    log_alpha = -beta * (e_new - state.energy) - d_kinetic
    accept = u < jnp.exp(jnp.minimum(log_alpha, 0.0))

    return state._replace(
        positions=jnp.where(accept, x, x0),
        energy=jnp.where(accept, e_new, state.energy),
        virial=jnp.where(accept, vir_new, state.virial),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.astype(state.accepts.dtype),
    )


def hmc_move(spec: SystemSpec, beta: float, state: ChainState,
             num_leapfrog: int = DEFAULT_NUM_LEAPFROG) -> ChainState:
    """One HMC trajectory + MH decision for a single (unbatched) chain."""
    key, k_mom, k_acc = jax.random.split(state.key, 3)
    n = spec.num_particles
    p0 = jax.random.normal(k_mom, (n, 2), dtype=state.positions.dtype)
    u = jax.random.uniform(k_acc, (), dtype=state.energy.dtype)
    return _hmc_apply(spec, beta, state, p0, u,
                      num_leapfrog)._replace(key=key)


def run_hmc(spec: SystemSpec, beta: float, state: ChainState,
            num_moves: int,
            num_leapfrog: int = DEFAULT_NUM_LEAPFROG) -> ChainState:
    """``num_moves`` sequential HMC updates on one chain (scan, chunked
    random tables like ``metropolis.run_moves``)."""
    key, k_mom, k_acc = jax.random.split(state.key, 3)
    n = spec.num_particles
    p_tab = jax.random.normal(k_mom, (num_moves, n, 2),
                              dtype=state.positions.dtype)
    u_tab = jax.random.uniform(k_acc, (num_moves,), dtype=state.energy.dtype)

    def body(s, xs):
        p0, u = xs
        return _hmc_apply(spec, beta, s, p0, u, num_leapfrog), None

    state, _ = jax.lax.scan(body, state._replace(key=key), (p_tab, u_tab))
    return state


def adjust_eps(state: ChainState,
               target_acceptance: float = HMC_TARGET_ACCEPTANCE
               ) -> ChainState:
    """Adapt the per-chain eps (stored in ``max_disp``) toward the HMC
    optimum; same clamped multiplicative rule as the displacement engine."""
    from flowstate.mcmc.metropolis import adjust_displacement
    return adjust_displacement(state, target_acceptance)


def run_hmc_equilibration(spec: SystemSpec, beta: float, state: ChainState,
                          num_steps: int, adjusting_frequency: int,
                          num_leapfrog: int = DEFAULT_NUM_LEAPFROG,
                          target_acceptance: float = HMC_TARGET_ACCEPTANCE
                          ) -> ChainState:
    """HMC moves with periodic eps adaptation (equilibration only,
    preserving detailed balance in production)."""
    num_blocks = num_steps // adjusting_frequency
    remainder = num_steps - num_blocks * adjusting_frequency

    def block(carry, _):
        s = run_hmc(spec, beta, carry, adjusting_frequency, num_leapfrog)
        s = adjust_eps(s, target_acceptance)
        return s, None

    if num_blocks > 0:
        state, _ = jax.lax.scan(block, state, None, length=num_blocks)
    if remainder > 0:
        state = run_hmc(spec, beta, state, remainder, num_leapfrog)
    return state


def run_hmc_batch(spec: SystemSpec, beta: float, state: ChainState,
                  num_moves: int,
                  num_leapfrog: int = DEFAULT_NUM_LEAPFROG) -> ChainState:
    return jax.vmap(
        lambda s: run_hmc(spec, beta, s, num_moves, num_leapfrog))(state)


def run_hmc_equilibration_batch(spec, beta, state, num_steps,
                                adjusting_frequency,
                                num_leapfrog=DEFAULT_NUM_LEAPFROG,
                                target_acceptance=HMC_TARGET_ACCEPTANCE):
    return jax.vmap(lambda s: run_hmc_equilibration(
        spec, beta, s, num_steps, adjusting_frequency, num_leapfrog,
        target_acceptance))(state)
