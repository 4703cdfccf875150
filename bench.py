"""Benchmark: Metropolis move throughput on the LJ double-well, plus the
flow phases (big moves, training steps, blocked moves).

Prints ONE JSON line:
  {"metric": "mc_moves_per_s", "value": N, "unit": "moves/s", ...}

The workload is the reference system (N=3 particles, rho=0.03, T=1.0,
V0=[-10, -10.5] double well — main_algorithm_1.py:32-53) advanced by the
batched engines: C chains on one GPU, moves sequential within chains.  Both
engines are timed — the plain engine (vmapped ``metropolis.run_moves``) and
the Triton move kernel (``mcmc/pallas_metropolis.py``) — at N=3 and N=8,
and the faster one at N=3 is the headline value.  Every timed segment runs
after two warm-up calls and ends in ``block_until_ready``.

Baseline: the reference's serial numpy engine
(``MCMC/monte_carlo.py:particle_displacement``) on one CPU core: 4312
moves/s (231.9 us/move, single chain, 3000-move timed run after a 200-move
warm-up).

Needs a GPU; the device's name and power limit are printed to stderr and
recorded in the output.
"""

import functools
import json
import sys
import time

import jax
import jax.numpy as jnp

from flowstate.mcmc import (
    init_chain_state, resync_energy, run_production_pallas,
)
from flowstate.mcmc.initialise import init_split_wells
from flowstate.mcmc.metropolis import run_moves
from flowstate.mcmc.pallas_metropolis import run_moves_pallas
from flowstate.ops import Box, SystemSpec
from flowstate.utils.profiling import (
    enable_compilation_cache, gpu_name_and_power,
)

REFERENCE_CPU_MOVES_PER_S = 4312.0

NUM_CHAINS = 16384
MOVES_PER_CALL = 1000
TIMED_CALLS = 30


def two_well_spec(n: int) -> SystemSpec:
    return SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)


def timed(step_fn, s, calls: int = TIMED_CALLS):
    """Seconds per call after two warm-up calls (compile + first run)."""
    for _ in range(2):
        s = step_fn(s)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    for _ in range(calls):
        s = step_fn(s)
    jax.block_until_ready(s)
    return (time.perf_counter() - t0) / calls, s


def engine_rates(n: int, beta: float = 1.0):
    """(plain, kernel) moves/s at N=n, and the kernel's final state."""
    spec = two_well_spec(n)
    positions, _ = init_split_wells(NUM_CHAINS, n, 0.03)
    state = init_chain_state(spec, jnp.asarray(positions), jax.random.key(0),
                             0.65)
    plain = jax.jit(jax.vmap(
        lambda x: run_moves(spec, beta, x, MOVES_PER_CALL)))
    # seed=None: the kernel derives a fresh per-call seed from state.key
    kernel = jax.jit(functools.partial(run_moves_pallas, spec, beta,
                                       num_moves=MOVES_PER_CALL))
    moves = NUM_CHAINS * MOVES_PER_CALL
    dt_plain, _ = timed(plain, state)
    dt_kernel, state = timed(kernel, state)
    return moves / dt_plain, moves / dt_kernel, resync_energy(spec, state)


def main() -> None:
    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {device.platform}")
    card = gpu_name_and_power()
    print(f"{device.device_kind} | nvidia-smi: {card}", file=sys.stderr)
    enable_compilation_cache()

    beta = 1.0
    spec = two_well_spec(3)
    xla_moves_per_s, kernel_moves_per_s, state = engine_rates(3, beta)
    xla_n8, kernel_n8, _ = engine_rates(8, beta)
    if kernel_moves_per_s > xla_moves_per_s:
        moves_per_s, engine = kernel_moves_per_s, "pallas_triton"
    else:
        moves_per_s, engine = xla_moves_per_s, "xla"

    acc = float(jnp.sum(state.accepts)) / float(jnp.sum(state.attempts))

    # ESS/s: timed production run with observable sampling (energy series)
    from flowstate.analysis import effective_sample_size

    # 256 samples/chain give a stable Geyer IAT estimate.  Four production
    # segments run in one jitted program that returns only the energy
    # series (still a short timed call on the H100: ROADMAP S1).
    prod_segments = 4

    @jax.jit
    def produce(s):
        es = []
        for _ in range(prod_segments):
            s, obs = run_production_pallas(spec, beta, s, 256, 25)
            es.append(obs.energy_per_particle)
        return s, jnp.concatenate(es, axis=1)

    dt_prod, (_, energies_d) = timed(lambda se: produce(se[0]),
                                     produce(state), calls=1)
    dt_prod /= prod_segments
    # the (C, 1024) series transfers outside the clock
    energies = jax.device_get(energies_d)
    ess_chains = 2048
    ess = effective_sample_size(energies[:ess_chains, :256])
    ess_per_s = ess * (NUM_CHAINS / ess_chains) / dt_prod

    hybrid = hybrid_phase_bench(spec, beta, state)

    print(json.dumps({
        "metric": "mc_moves_per_s",
        "value": round(moves_per_s, 1),
        "unit": "moves/s",
        "vs_baseline": round(moves_per_s / REFERENCE_CPU_MOVES_PER_S, 2),
        "engine": engine,
        "xla_moves_per_s": round(xla_moves_per_s, 1),
        "pallas_moves_per_s": round(kernel_moves_per_s, 1),
        "xla_moves_per_s_n8": round(xla_n8, 1),
        "pallas_moves_per_s_n8": round(kernel_n8, 1),
        "chains": NUM_CHAINS,
        "acceptance": round(acc, 4),
        # energy-series ESS (a fast observable); the value and the timed
        # segment are recorded apart so a swing can be attributed
        "ess_per_s": round(ess_per_s, 1),
        "ess_value": round(float(ess), 1),
        "ess_chains_estimated": ess_chains,
        "prod_segment_s": round(dt_prod, 4),
        "ess_observable": "energy",
        **hybrid,
        "device": str(device),
        "device_kind": device.device_kind,
        "nvidia_smi": card,
    }))


def hybrid_phase_bench(spec, beta, state) -> dict:
    """Flow-phase throughput: batched big moves, training steps, blocked
    moves.

    The reference's structural bottleneck is one CPU<->GPU round trip per
    big-move proposal (monte_carlo.py:255-262, one config at a time); here
    one device batch proposes + judges for all chains at once, so the
    number to record is whole-ensemble big-move rounds/s.  Training is the
    A1 full-scale config (batch 512, K=15, hidden 256, 32 bins —
    main_algorithm_1.py:57-67).
    """
    from flowstate.flows import (
        build_circular_flow, build_conditional_circular_flow,
    )
    from flowstate.mcmc import (
        blocked_big_moves, fourier_context, fourier_context_dim,
    )
    from flowstate.mcmc.hybrid import nf_big_moves
    from flowstate.training import TrainConfig, make_optimizer
    from flowstate.training.data import epoch_batches
    from flowstate.training.train import TrainState, make_train_step

    half_box = float(spec.box.size_x) / 2
    model = build_circular_flow(3, 2, half_box, K=15, hidden_units=256,
                                num_bins=32, num_blocks=2)
    params = model.init_params(jax.random.key(7))

    # -- big moves: sample_and_log_prob + batched energies + MH, all
    #    chains; ROUNDS_PER_CALL rounds inside one jitted scan
    ROUNDS_PER_CALL = 64
    BIG_CALLS = 3

    @jax.jit
    def big_rounds(s):
        def body(carry, _):
            return nf_big_moves(spec, beta, carry, model, params,
                                half_box).state, None
        s2, _ = jax.lax.scan(body, s, None, length=ROUNDS_PER_CALL)
        return s2

    dt_big, _ = timed(big_rounds, state, BIG_CALLS)
    rounds_per_s = ROUNDS_PER_CALL / dt_big

    # -- training steps/s at the A1 config: the host-shuffled batch tensor
    #    is the program argument and the TrainState carry is donated; all
    #    epochs run in ONE flat scan over steps
    cfg = TrainConfig(batch_size=512, epochs=1, lr=1e-4)
    data = jax.random.uniform(jax.random.key(8), (102400, 6),
                              minval=-half_box, maxval=half_box)
    optimizer = make_optimizer(cfg)
    step = make_train_step(model, cfg, optimizer)
    p0 = jax.tree_util.tree_map(jnp.copy, params)
    tstate = TrainState(p0, optimizer.init(p0), jax.random.key(9))

    epochs_timed = 8
    n_steps = data.shape[0] // cfg.batch_size

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_epochs(ts, batches):            # (E * n_steps, B, D)
        return jax.lax.scan(step, ts, batches)[0]

    @jax.jit
    def shuffle_all(key):
        keys = jax.random.split(key, epochs_timed)
        return jnp.concatenate([epoch_batches(k, data, cfg.batch_size)
                                for k in keys])

    batches = shuffle_all(jax.random.key(11))
    dt_train, _ = timed(lambda ts: run_epochs(ts, batches), tstate, 4)
    train_steps_per_s = n_steps * epochs_timed / dt_train

    # -- blocked conditional moves (mcmc/blocked.py) at N=8, k=1 with the
    #    conditional flow at its production depth K=6: one move per chain
    #    per round, ROUNDS_PER_CALL rounds per call
    n_blk = 8
    spec8 = two_well_spec(n_blk)
    hb8 = float(spec8.box.size_x) / 2
    k_depth = 6
    cmodel = build_conditional_circular_flow(
        1, 2, hb8, context_features=fourier_context_dim(3), K=k_depth,
        hidden_units=128, num_bins=16)
    cparams = cmodel.init_params(jax.random.key(21))
    ctx_fn = lambda r, p: fourier_context(r, p, hb8, m_max=3)  # noqa: E731
    pos8, _ = init_split_wells(NUM_CHAINS, n_blk, 0.03)
    st8 = init_chain_state(spec8, jnp.asarray(pos8), jax.random.key(22),
                           0.65)

    @jax.jit
    def blocked_rounds(s1):
        def body(carry, _):
            return blocked_big_moves(spec8, beta, carry, cmodel, cparams,
                                     hb8, 1, context_fn=ctx_fn).state, None
        s2, _ = jax.lax.scan(body, s1, None, length=ROUNDS_PER_CALL)
        return s2

    dt_blk, _ = timed(blocked_rounds, st8, BIG_CALLS)
    return {
        "big_moves_per_s": round(NUM_CHAINS * rounds_per_s, 1),
        "big_move_chains": NUM_CHAINS,
        "train_steps_per_s": round(train_steps_per_s, 2),
        "train_batch": cfg.batch_size,
        "blocked_moves_per_s": round(
            NUM_CHAINS * ROUNDS_PER_CALL / dt_blk, 1),
        "blocked_move_system": f"N={n_blk} k=1 K={k_depth} hidden=128",
    }


if __name__ == "__main__":
    main()
