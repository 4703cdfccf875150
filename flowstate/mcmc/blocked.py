"""Blocked conditional-flow proposals: resample k particles given the rest.

The round-4 N-scaling study measured the GLOBAL independence proposal's
acceptance decaying as ln(acc) = -1.006 N + 1.04 — one lost decade per
~2.3 particles — and diagnosed the cause: the coordinate-wise spline
coupling cannot encode N-body exclusion volume, so 70-85% of whole-config
proposals at N>=8 contain a hard-core overlap
(``results/evidence/n_mitigation.json``).  The structural fix is to stop
proposing all N particles at once: resample a BLOCK of k particles from a
flow *conditioned on the other N-k positions*, Metropolis-Hastings
corrected with the conditional log-probs.  The decay law then predicts
acceptance ~ e * 10^(-k/2.3) *independent of N* — the prediction this
module exists to test (``tools/blocked_wall.py``).

Reference lineage (capability the reference ships but never wires):
* move semantics generalize ``nf_big_move`` — ``MCMC/monte_carlo.py:235-303``
* conditioning machinery — ``NF/normflows/core.py:233-383``
  (ConditionalNormalizingFlow) + ``nets/resnet.py:48-49`` (context GLU)

Design
------
* Block membership is a fresh uniformly-random k-subset per chain per
  attempt (auxiliary randomness drawn independently of the state, so
  detailed balance holds: the reverse move draws the same subset with the
  same probability, and the context — built ONLY from the unchanged N-k
  positions — is identical both ways).
* All particle selection/scatter is one-hot einsum against the positions
  tensor, never ``take_along_axis``/gather (a choice made for the first
  machine's gathers; whether a gather is cheaper on the GPU is ROADMAP
  S4).
* One device batch proposes for all C chains at once: a single
  ``sample_and_log_prob`` with per-chain context, a vmapped O(N^2) energy
  recompute, and a branchless where-select accept — the same shape as
  ``mcmc/hybrid.py``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.mcmc.hybrid import BigMoveResult
from flowstate.mcmc.state import ChainState
from flowstate.ops.pair_energy import SystemSpec, total_energy_virial


def random_block_onehots(key: jax.Array, batch: int, n: int, k: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row random k-subsets as one-hot selectors.

    Returns ``(sel, rest)``: ``sel[b, j, p]`` is 1.0 where particle p is
    the j-th block member of row b (shape (B, k, N)); ``rest`` likewise
    for the other N-k particles (shape (B, N-k, N)).  The subset and the
    within-block/within-rest orders come from a uniform random permutation
    (argsort of uniforms — a sort, not a gather), so every k-subset is
    equally likely and the context ordering is random — the training-time
    augmentation (``training/blocked.py``) matches this distribution.
    """
    u = jax.random.uniform(key, (batch, n))
    perm = jnp.argsort(u, axis=-1)                       # (B, N)
    onehot = (perm[:, :, None] == jnp.arange(n)[None, None, :]
              ).astype(jnp.float32)                      # (B, N, N)
    return onehot[:, :k, :], onehot[:, k:, :]


def select_particles(onehot: jnp.ndarray, positions: jnp.ndarray
                     ) -> jnp.ndarray:
    """(B, m, N) one-hot x (B, N, d) -> (B, m, d), via matmul."""
    return jnp.einsum("bmn,bnd->bmd", onehot, positions)


def scatter_block(sel: jnp.ndarray, block: jnp.ndarray,
                  positions: jnp.ndarray) -> jnp.ndarray:
    """Replace the selected rows of ``positions`` with ``block``.

    ``sel`` (B, k, N) one-hot, ``block`` (B, k, d): the non-members keep
    their old coordinates, members take the block values — all where/einsum.
    """
    member = jnp.sum(sel, axis=1)[..., None]             # (B, N, 1) 0/1
    scattered = jnp.einsum("bkn,bkd->bnd", sel, block)
    return positions * (1.0 - member) + scattered


def block_context(rest: jnp.ndarray, positions: jnp.ndarray,
                  half_box: float) -> jnp.ndarray:
    """Periodic features of the N-k conditioning particles, (B, 4(N-k)).

    cos/sin at scale pi/half_box of the centered coordinates — the same
    featurization the coupling applies to its identity half
    (``utils/nn.py:120-137`` semantics), computed once per proposal so
    every one of the K couplings reuses it.
    """
    others = select_particles(rest, positions) - half_box  # centered
    flat = others.reshape(*others.shape[:-2], -1)
    scale = np.pi / half_box
    return jnp.concatenate([jnp.cos(scale * flat),
                            jnp.sin(scale * flat)], axis=-1)


def context_dim(n: int, k: int, num_dim: int = 2) -> int:
    """Context feature count for ``block_context`` (coords mode)."""
    return 2 * (n - k) * num_dim


def fourier_context(rest: jnp.ndarray, positions: jnp.ndarray,
                    half_box: float, m_max: int = 3) -> jnp.ndarray:
    """Permutation-INVARIANT context: Fourier modes of the conditioning set.

    The raw-coordinate context (``block_context``) feeds the conditioner
    the N-k positions in a random order, forcing the MLP to learn
    approximate set invariance from augmentation alone.  This encoder is
    exactly invariant by construction: the first (2m_max+1)^2 torus
    density modes of the conditioning particles,

        c_m = (1/(N-k)) sum_j exp(i * 2*pi/L * m . r_j),  |m_x|,|m_y| <= m_max,

    returned as stacked cos/sin sums — a fixed trig + matmul featurization
    (no parameters, no gathers) whose width is independent of N, so one
    conditional flow architecture serves every system size.  Preserves MH
    validity for the same reason as ``block_context``: it reads only the
    unchanged N-k positions.
    """
    others = select_particles(rest, positions)       # (B, N-k, 2) box frame
    ms = np.arange(-m_max, m_max + 1)
    mx, my = np.meshgrid(ms, ms, indexing="ij")
    modes = np.stack([mx.ravel(), my.ravel()], -1)   # (M, 2)
    scale = np.pi / half_box                          # = 2*pi / L
    phase = scale * jnp.einsum("bnd,md->bnm", others,
                               jnp.asarray(modes, jnp.float32))
    nk = max(others.shape[-2], 1)
    return jnp.concatenate([jnp.sum(jnp.cos(phase), axis=-2),
                            jnp.sum(jnp.sin(phase), axis=-2)],
                           axis=-1) / nk


def fourier_context_dim(m_max: int = 3) -> int:
    """Context feature count for ``fourier_context``."""
    return 2 * (2 * m_max + 1) ** 2


def blocked_big_moves(spec: SystemSpec, beta: float, state: ChainState,
                      model, params, half_box: float,
                      k: int, context_fn=None,
                      paired: bool = True) -> BigMoveResult:
    """One blocked conditional-flow move per chain, batched.

    ``model`` is a ``ConditionalNormalizingFlow`` over the block's 2k
    coordinates (``flows.build_conditional_circular_flow``); its context
    is ``block_context`` of the other N-k particles.  MH log-ratio:

        log r = -beta dU + log q(old_block | rest) - log q(new_block | rest)

    — ``nf_big_move``'s independence correction (monte_carlo.py:268, with
    the documented Hastings sign FIXED as in ``mcmc/hybrid.py``) applied
    to the conditional proposal.

    ``context_fn(rest_onehot, positions) -> (C, F)`` selects the context
    encoding (default: ``block_context`` raw cos/sin coords; pass
    ``fourier_context`` for the invariant-modes encoder) — it MUST match
    the encoding the flow was trained with (``training/blocked.py``).
    """
    c, n = state.positions.shape[:2]
    if context_fn is None:
        context_fn = lambda r, p: block_context(r, p, half_box)  # noqa: E731

    keys = jax.vmap(lambda kk: jax.random.split(kk, 3))(state.key)  # (C,3,..)
    new_chain_keys = keys[:, 0]
    u = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys[:, 1])
    # batch-level draws use keys folded away from every chain's stream
    k_blocks = jax.random.fold_in(keys[0, 2], 0x51ED)
    k_prop = jax.random.fold_in(keys[0, 2], 0xB10C)

    sel, rest = random_block_onehots(k_blocks, c, n, k)
    ctx = context_fn(rest, state.positions)

    old_block = select_particles(sel, state.positions) - half_box
    old_flat = old_block.reshape(c, -1)
    if paired:
        # forward (sample) + inverse (old log_prob) sweeps in ONE K-step
        # lockstep scan — halves the serial coupling-chain depth, the
        # move's dominant cost (+10% measured round rate)
        new_flat, log_q_new, log_q_old = model.sample_and_log_prob_with_old(
            params, k_prop, c, old_flat, context=ctx)
    else:
        log_q_old = model.log_prob(params, old_flat, context=ctx)
        new_flat, log_q_new = model.sample_and_log_prob(params, k_prop, c,
                                                        context=ctx)
    new_block = new_flat.reshape(c, k, 2) + half_box
    proposals = scatter_block(sel, new_block, state.positions)

    enn, virn = jax.vmap(lambda p: total_energy_virial(spec, p))(proposals)
    ratio_log = (-beta * (enn - state.energy)) + (log_q_old - log_q_new)
    accept = u < jnp.exp(ratio_log)

    def pick(new, old):
        bshape = (c,) + (1,) * (new.ndim - 1)
        return jnp.where(accept.reshape(bshape), new, old)

    new_state = state._replace(
        positions=pick(proposals, state.positions),
        energy=jnp.where(accept, enn, state.energy),
        virial=jnp.where(accept, virn, state.virial),
        attempts=state.attempts + 1,
        accepts=state.accepts + accept.astype(state.accepts.dtype),
        key=new_chain_keys,
    )
    return BigMoveResult(state=new_state, accepted=accept,
                         ratio_log=ratio_log, proposal_energy=enn)
