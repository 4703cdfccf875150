"""MALA: gradient-informed whole-configuration moves (beyond-reference).

Metropolis-adjusted Langevin: propose ``y = x - tau*beta*grad U(x) +
sqrt(2 tau) xi`` for ALL particles at once and MH-correct with the
Gaussian proposal ratio, so the stationary distribution is exactly the
Boltzmann measure.  This is a capability the reference cannot express:
its numpy physics defines ``lennard_jones_force`` but never calls it
(``MCMC/potential.py:38-46``, noted unused in SURVEY.md §2.1); here the
pure-jnp energy (``ops/pair_energy.py``) is differentiable, so Langevin
drifts come from ``jax.grad`` of the SAME energy the Metropolis engine
samples — no second physics implementation to keep in sync.

Design notes:

* The per-chain step size tau lives in ``ChainState.max_disp`` (same
  adaptation machinery as the displacement engine; target acceptance
  0.574, the MALA optimum).
* Proposals wrap into the box; the proposal density uses the min-image
  displacement, i.e. the dominant term of the wrapped Gaussian.  The
  neglected image terms are O(exp(-L^2/4 tau)) — ~1e-1000 at the
  simulated scales — so detailed balance holds to machine precision.
* A proposal into the hard core has ``U = +inf`` so ``exp(log_alpha) = 0``
  and it is rejected, exactly like the displacement engine
  (``energy_calculator.py:73-76`` semantics).
* Energies/virials are recomputed exactly on every move (whole-config
  proposals make the O(N^2) recompute the natural cost), so the tracked
  totals never drift.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from flowstate.mcmc.state import ChainState
from flowstate.ops.box import min_image, wrap_pbc
from flowstate.ops.pair_energy import SystemSpec, total_energy_virial


def potential_gradient(spec: SystemSpec, positions: jnp.ndarray
                       ) -> jnp.ndarray:
    """grad_x U(x) of the full system energy for one (N, 2) configuration.

    Finite at every valid (non-overlapping) configuration; non-finite
    values (an overlapping input) are zeroed so the drift never produces
    NaN positions — the MH step then rejects on the energy.
    """
    g = jax.grad(lambda p: total_energy_virial(spec, p)[0])(positions)
    return jnp.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)


def _mala_apply(spec: SystemSpec, beta: float, state: ChainState,
                noise: jnp.ndarray, u: jnp.ndarray) -> ChainState:
    """One MALA update for a single chain given pre-drawn randoms.

    noise: (N, 2) standard normals; u: acceptance uniform.
    """
    x = state.positions
    tau = state.max_disp
    drift_x = -tau * beta * potential_gradient(spec, x)
    y = wrap_pbc(x + drift_x + jnp.sqrt(2.0 * tau) * noise, spec.box)

    e_new, vir_new = total_energy_virial(spec, y)
    drift_y = -tau * beta * potential_gradient(spec, y)

    # min-image displacements = the dominant wrapped-Gaussian term
    d_fwd = min_image(y - (x + drift_x), spec.box)
    d_rev = min_image(x - (y + drift_y), spec.box)
    log_q_fwd = -jnp.sum(d_fwd * d_fwd) / (4.0 * tau)
    log_q_rev = -jnp.sum(d_rev * d_rev) / (4.0 * tau)

    # an inf proposal energy gives log_alpha = -inf -> exp 0 -> reject
    log_alpha = -beta * (e_new - state.energy) + log_q_rev - log_q_fwd
    accept = u < jnp.exp(jnp.minimum(log_alpha, 0.0))

    return state._replace(
        positions=jnp.where(accept, y, x),
        energy=jnp.where(accept, e_new, state.energy),
        virial=jnp.where(accept, vir_new, state.virial),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.astype(state.accepts.dtype),
    )


def mala_move(spec: SystemSpec, beta: float, state: ChainState
              ) -> ChainState:
    """One MALA attempt for a single (unbatched) chain."""
    key, k_noise, k_acc = jax.random.split(state.key, 3)
    n = spec.num_particles
    noise = jax.random.normal(k_noise, (n, 2), dtype=state.positions.dtype)
    u = jax.random.uniform(k_acc, (), dtype=state.energy.dtype)
    return _mala_apply(spec, beta, state, noise, u)._replace(key=key)


def run_mala(spec: SystemSpec, beta: float, state: ChainState,
             num_moves: int) -> ChainState:
    """``num_moves`` sequential MALA updates on one chain (scan, chunked
    random tables like ``metropolis.run_moves``)."""
    key, k_noise, k_acc = jax.random.split(state.key, 3)
    n = spec.num_particles
    noise_tab = jax.random.normal(k_noise, (num_moves, n, 2),
                                  dtype=state.positions.dtype)
    u_tab = jax.random.uniform(k_acc, (num_moves,), dtype=state.energy.dtype)

    def body(s, xs):
        noise, u = xs
        return _mala_apply(spec, beta, s, noise, u), None

    state, _ = jax.lax.scan(body, state._replace(key=key),
                            (noise_tab, u_tab))
    return state


MALA_TARGET_ACCEPTANCE = 0.574  # the MALA-optimal rate


def adjust_tau(state: ChainState,
               target_acceptance: float = MALA_TARGET_ACCEPTANCE
               ) -> ChainState:
    """Adapt the per-chain tau (stored in ``max_disp``) toward the MALA
    optimum; same clamped multiplicative rule as the displacement engine."""
    from flowstate.mcmc.metropolis import adjust_displacement
    return adjust_displacement(state, target_acceptance)


def run_mala_equilibration(spec: SystemSpec, beta: float, state: ChainState,
                           num_steps: int, adjusting_frequency: int,
                           target_acceptance: float = MALA_TARGET_ACCEPTANCE
                           ) -> ChainState:
    """MALA moves with periodic tau adaptation (equilibration only,
    preserving detailed balance in production)."""
    num_blocks = num_steps // adjusting_frequency
    remainder = num_steps - num_blocks * adjusting_frequency

    def block(carry, _):
        s = run_mala(spec, beta, carry, adjusting_frequency)
        s = adjust_tau(s, target_acceptance)
        return s, None

    if num_blocks > 0:
        state, _ = jax.lax.scan(block, state, None, length=num_blocks)
    if remainder > 0:
        state = run_mala(spec, beta, state, remainder)
    return state


def run_mala_batch(spec: SystemSpec, beta: float, state: ChainState,
                   num_moves: int) -> ChainState:
    return jax.vmap(lambda s: run_mala(spec, beta, s, num_moves))(state)


def run_mala_equilibration_batch(spec, beta, state, num_steps,
                                 adjusting_frequency,
                                 target_acceptance=MALA_TARGET_ACCEPTANCE):
    return jax.vmap(lambda s: run_mala_equilibration(
        spec, beta, s, num_steps, adjusting_frequency,
        target_acceptance))(state)
