"""Pallas (Triton) kernel: a whole segment of Metropolis moves in one program.

The plain engine (``mcmc/metropolis.py``) is a vmapped ``lax.fori_loop``
over chunks of moves; on the GPU every move becomes a few small kernel
launches over the (chains, N, 2) state.  This kernel runs the whole
segment inside one program instead: each lane of the block owns one chain,
the chain's particle coordinates stay in registers as (N_PAD, BLOCK_C) x and
y tiles for the whole segment, and the move loop runs inside the kernel.

Semantics match ``metropolis.py`` (single-particle displacement, wrap PBC,
truncated-shifted LJ + double well, hard-core rejection, Metropolis rule).
Only the random stream differs: the kernel draws its numbers from a
counter-based Threefry-2x32 generator keyed by (seed, global chain index,
move index), so agreement with the plain engine is statistical and is
asserted by the quadrature and engine-comparison tests.

Registers cannot be indexed dynamically, so the moving particle is picked
by a one-hot select over the particle rows.  The particle axis is padded
to the next power of two (a Triton block dimension must be one) and the
padded rows are masked out of every sum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from flowstate.mcmc.state import ChainState
from flowstate.ops.pair_energy import SystemSpec

BLOCK_C = 32       # chains per program, one per lane: 16,384 chains give
                   # 512 programs, about four per SM on a 132-SM card; the
                   # fastest of 32/64/128/256 lanes at N=3 and N=8 (H100)
NUM_WARPS = 1      # one warp holds the BLOCK_C lanes
MAX_PARTICLES = 64  # largest N whose (N_PAD, BLOCK_C) tiles stay in
                    # registers: the time per move grows 1.7x from N=32 to
                    # 64 but 5.9x from 64 to 128 (H100).  Above it
                    # run_moves_auto takes the plain engine.

HARD_CORE_E = 1e30  # finite stand-in for +inf inside the kernel

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 arrays (Salmon et al., 2011).

    The same function as ``jax.random``'s default generator, written in
    plain uint32 adds, rotations and xors so that it lowers inside a
    Triton kernel.  Returns the two output words.
    """
    k2 = k0 ^ k1 ^ jnp.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def uniform_from_bits(bits):
    """uint32 -> float32 uniform in [0, 1) from the 24 high bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / 16777216.0)


def move_randoms(k0, k1, chain, move):
    """The four random numbers of one move for each chain in ``chain``.

    Counter = (chain index, 2 * move + j) for j = 0, 1.  Returns the
    particle-choice bits, the two displacement uniforms and the acceptance
    uniform.
    """
    ctr = (2 * move).astype(jnp.uint32)
    w0, w1 = threefry2x32(k0, k1, chain, ctr)
    w2, w3 = threefry2x32(k0, k1, chain, ctr + jnp.uint32(1))
    return w0, uniform_from_bits(w1), uniform_from_bits(w2), \
        uniform_from_bits(w3)


def _move_kernel(key_ref, px_ref, py_ref, e_ref, md_ref,
                 px_out, py_out, e_out, acc_out, *,
                 spec: SystemSpec, beta: float, num_moves: int, n_pad: int):
    """One block of BLOCK_C chains: ``num_moves`` sequential updates."""
    n = spec.num_particles
    lx, ly = spec.box.size_x, spec.box.size_y
    inv_lx, inv_ly = 1.0 / lx, 1.0 / ly
    r_cut2 = spec.cutoff * spec.cutoff
    hc2 = spec.hard_core * spec.hard_core
    sr6_cut = (spec.sigma**2 / r_cut2) ** 3
    shift = 4.0 * spec.epsilon * (sr6_cut * sr6_cut - sr6_cut)

    k0 = key_ref[0]
    k1 = key_ref[1]
    chain = (pl.program_id(0) * BLOCK_C
             + jnp.arange(BLOCK_C, dtype=jnp.int32)).astype(jnp.uint32)
    rows = jnp.arange(n_pad, dtype=jnp.int32)[:, None]     # (n_pad, 1)
    valid = rows < n
    md = md_ref[...]

    def min_image(d, length, inv_length):
        return d - length * jnp.floor(d * inv_length + 0.5)

    def well_energy(x, y):
        v = jnp.zeros_like(x)
        centers = [(lx / 4.0, ly / 2.0), (3.0 * lx / 4.0, ly / 2.0)]
        for w in range(spec.num_wells):
            dx = min_image(x - centers[w][0], lx, inv_lx)
            dy = min_image(y - centers[w][1], ly, inv_ly)
            r = jnp.sqrt(dx * dx + dy * dy)
            t = 0.5 * (1.0 + jnp.tanh(spec.k * (r - spec.r0)))
            v = v + spec.V0_list[w] * (1.0 - t)
        return v

    def particle_energy(px, py, x0, y0, others):
        """Energy of a particle at (x0, y0) against the ``others`` rows."""
        dx = min_image(x0[None, :] - px, lx, inv_lx)
        dy = min_image(y0[None, :] - py, ly, inv_ly)
        r2 = dx * dx + dy * dy
        sr2 = spec.sigma**2 / jnp.maximum(r2, 1e-12)
        sr6 = sr2 * sr2 * sr2
        e_pair = 4.0 * spec.epsilon * (sr6 * sr6 - sr6) - shift
        e = jnp.sum(jnp.where(others & (r2 <= r_cut2), e_pair, 0.0), axis=0)
        overlap = jnp.max(jnp.where(others & (r2 < hc2), 1.0, 0.0), axis=0)
        return jnp.where(overlap > 0.0, HARD_CORE_E, e) + well_energy(x0, y0)

    def body(i, carry):
        px, py, e, acc = carry
        bits, u1, u2, ua = move_randoms(k0, k1, chain, i)
        p = (bits % jnp.uint32(n)).astype(jnp.int32)
        p_sel = rows == p[None, :]                  # (n_pad, BLOCK_C)
        others = valid & jnp.logical_not(p_sel)
        x0 = jnp.sum(jnp.where(p_sel, px, 0.0), axis=0)
        y0 = jnp.sum(jnp.where(p_sel, py, 0.0), axis=0)
        x1 = x0 + (u1 - 0.5) * md
        y1 = y0 + (u2 - 0.5) * md
        x1 = x1 - lx * jnp.floor(x1 * inv_lx)       # wrap into [0, L)
        y1 = y1 - ly * jnp.floor(y1 * inv_ly)

        de = (particle_energy(px, py, x1, y1, others)
              - particle_energy(px, py, x0, y0, others))
        accept = (de <= 0.0) | (ua < jnp.exp(-beta * de))
        moved = accept[None, :] & p_sel
        px = jnp.where(moved, x1[None, :], px)
        py = jnp.where(moved, y1[None, :], py)
        e = e + jnp.where(accept, de, 0.0)
        acc = acc + accept.astype(jnp.int32)
        return px, py, e, acc

    px, py, e, acc = jax.lax.fori_loop(
        0, num_moves, body,
        (px_ref[...], py_ref[...], e_ref[...],
         jnp.zeros((BLOCK_C,), jnp.int32)))
    px_out[...] = px
    py_out[...] = py
    e_out[...] = e
    acc_out[...] = acc


def kernel_key(state: ChainState, seed=None) -> jnp.ndarray:
    """The (2,) uint32 Threefry key of one kernel call.

    Derived from chain 0's PRNG key unless ``seed`` is given, so that
    successive calls on an advancing state draw fresh streams.
    """
    key = state.key[0] if seed is None else jax.random.key(seed)
    return jax.random.bits(key, (2,), jnp.uint32)


def run_moves_pallas(spec: SystemSpec, beta: float, state: ChainState,
                     num_moves: int, seed=None,
                     interpret: bool = False) -> ChainState:
    """Advance a batched ChainState by ``num_moves`` with the kernel.

    Any chain count is accepted (the chain axis is padded by replicating
    the last chain up to a BLOCK_C multiple, and the padding is dropped on
    return) and any particle count up to MAX_PARTICLES; above that, use
    ``run_moves_auto``, which takes the plain engine.

    The virial is NOT tracked move-by-move (it is an observable, not
    needed for acceptance), so the returned state's ``virial`` field is
    POISONED with NaN: any pressure computed from it is visibly wrong
    instead of silently stale.  ``resync_energy`` restores it (and clears
    the accumulated fp32 energy drift) before observable sampling.
    """
    c = state.positions.shape[0]
    n = spec.num_particles
    if n > MAX_PARTICLES:
        raise ValueError(
            f"pallas move kernel supports up to {MAX_PARTICLES} particles "
            f"(got {n}); use run_moves_auto for automatic dispatch")
    n_pad = 1 << (n - 1).bit_length()      # next power of two >= n
    c_pad = -(-c // BLOCK_C) * BLOCK_C

    def pad_chains(x):
        if c_pad == c:
            return x
        return jnp.concatenate(
            [x, jnp.broadcast_to(x[-1:], (c_pad - c,) + x.shape[1:])])

    positions = jnp.pad(pad_chains(state.positions),
                        ((0, 0), (0, n_pad - n), (0, 0)))
    px = positions[..., 0].T                         # (n_pad, c_pad)
    py = positions[..., 1].T

    tile = pl.BlockSpec((n_pad, BLOCK_C), lambda i: (0, i))
    lanes = pl.BlockSpec((BLOCK_C,), lambda i: (i,))
    px_o, py_o, e_o, acc_o = pl.pallas_call(
        functools.partial(_move_kernel, spec=spec, beta=beta,
                          num_moves=num_moves, n_pad=n_pad),
        grid=(c_pad // BLOCK_C,),
        in_specs=[pl.BlockSpec((2,), lambda i: (0,)), tile, tile, lanes,
                  lanes],
        out_specs=[tile, tile, lanes, lanes],
        out_shape=[jax.ShapeDtypeStruct((n_pad, c_pad), jnp.float32)] * 2
        + [jax.ShapeDtypeStruct((c_pad,), jnp.float32),
           jax.ShapeDtypeStruct((c_pad,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                    num_stages=1),
        interpret=interpret,
        name="metropolis_moves",
    )(kernel_key(state, seed), px, py, pad_chains(state.energy),
      pad_chains(state.max_disp))

    new_pos = jnp.stack([px_o.T[:c, :n], py_o.T[:c, :n]], axis=-1)
    new_keys = jax.vmap(lambda k: jax.random.split(k, 2)[0])(state.key)
    return state._replace(
        positions=new_pos,
        energy=e_o[:c],
        virial=jnp.full_like(state.virial, jnp.nan),  # poisoned; see above
        attempts=state.attempts + num_moves,
        accepts=state.accepts + acc_o[:c],
        key=new_keys,
    )


def run_production_pallas(spec: SystemSpec, beta: float, state: ChainState,
                          num_samples: int, sampling_frequency: int,
                          start_cycle: int = 0):
    """Production with observable sampling, move segments on the kernel:
    scan over ``num_samples`` blocks of ``sampling_frequency`` moves,
    resyncing energy/virial (the kernel poisons the virial) before each
    observable record.  Drop-in for ``run_production_batch`` —
    observables leaves come back shaped (C, num_samples, ...).

    The per-block resync is one O(N^2) batched recompute per
    ``sampling_frequency`` moves and doubles as drift control: the
    recorded energies are exact, not fp32-accumulated.
    """
    from flowstate.mcmc.metropolis import sample_observables
    from flowstate.mcmc.state import resync_energy

    def block(carry, i):
        s = run_moves_pallas(spec, beta, carry, sampling_frequency)
        s = resync_energy(spec, s)
        obs = sample_observables(
            spec, beta, s, start_cycle + (i + 1) * sampling_frequency)
        return s, obs

    state, obs = jax.lax.scan(block, state, jnp.arange(num_samples))
    # scan stacks on axis 0 (time); match run_production_batch's (C, T, ...)
    c = state.positions.shape[0]
    obs = jax.tree_util.tree_map(
        lambda x: (jnp.moveaxis(x, 0, 1) if x.ndim > 1
                   else jnp.broadcast_to(x[None], (c, x.shape[0]))), obs)
    return state, obs


def run_moves_auto(spec: SystemSpec, beta: float, state: ChainState,
                   num_moves: int, seed=None) -> ChainState:
    """Run a move segment on the kernel for N <= MAX_PARTICLES, and on the
    plain engine (``metropolis.run_moves``) above it.

    The plain engine tracks the virial exactly; after the kernel the
    virial is NaN-poisoned until ``resync_energy``.
    """
    if spec.num_particles <= MAX_PARTICLES:
        return run_moves_pallas(spec, beta, state, num_moves, seed=seed)
    from flowstate.mcmc.metropolis import run_moves
    return jax.vmap(lambda s: run_moves(spec, beta, s, num_moves))(state)
