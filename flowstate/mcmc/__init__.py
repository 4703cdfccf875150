"""Batched Metropolis MCMC engine + hybrid flow-MH moves."""

from flowstate.mcmc.blocked import (
    block_context,
    blocked_big_moves,
    context_dim,
    fourier_context,
    fourier_context_dim,
    random_block_onehots,
    scatter_block,
    select_particles,
)
from flowstate.mcmc.hybrid import (
    BigMoveResult,
    apply_big_moves,
    bulk_judge_flow,
    judge_flow,
    nf_big_moves,
    to_box_frame,
    to_centered,
)
from flowstate.mcmc.initialise import (
    init_alternating_wells,
    initialise_fcc,
    initialise_fcc_left_half,
    initialise_fcc_right_half,
    initialise_low_left,
    initialise_low_right,
)
from flowstate.mcmc.hmc import (
    DEFAULT_NUM_LEAPFROG, HMC_TARGET_ACCEPTANCE, adjust_eps, hmc_move,
    run_hmc, run_hmc_batch, run_hmc_equilibration,
    run_hmc_equilibration_batch,
)
from flowstate.mcmc.mala import (
    MALA_TARGET_ACCEPTANCE, adjust_tau, mala_move, potential_gradient,
    run_mala, run_mala_batch, run_mala_equilibration,
    run_mala_equilibration_batch,
)
from flowstate.mcmc.metropolis import (
    Observables,
    adjust_displacement,
    metropolis_move,
    run_equilibration,
    run_equilibration_batch,
    run_moves,
    run_moves_batch,
    run_production,
    run_production_batch,
    run_production_with,
    run_production_with_batch,
    sample_observables,
)
from flowstate.mcmc.observables import (
    acceptance_fraction,
    check_equilibration,
    ensemble_acceptance,
)
from flowstate.mcmc.pallas_metropolis import (
    run_moves_auto, run_moves_pallas, run_production_pallas,
)
from flowstate.mcmc.state import ChainState, init_chain_state, resync_energy
from flowstate.mcmc.tempering import (
    ReplicaExchangeResult,
    SwapResult,
    init_tempered_state,
    run_replica_exchange,
    run_tempered_moves,
    swap_replicas,
    swap_replicas_replica_sharded,
    temperature_ladder,
)

__all__ = [
    "ChainState", "init_chain_state", "resync_energy",
    "metropolis_move", "run_moves", "run_moves_batch",
    "run_production", "run_production_batch",
    "run_production_with", "run_production_with_batch",
    "run_equilibration", "run_equilibration_batch",
    "adjust_displacement", "sample_observables", "Observables",
    "nf_big_moves", "apply_big_moves", "judge_flow", "bulk_judge_flow",
    "blocked_big_moves", "random_block_onehots", "select_particles",
    "scatter_block", "block_context", "context_dim",
    "fourier_context", "fourier_context_dim",
    "run_moves_pallas",
    "run_moves_auto",
    "run_production_pallas",
    "BigMoveResult", "to_centered", "to_box_frame",
    "initialise_fcc", "initialise_low_left", "initialise_low_right",
    "initialise_fcc_left_half", "initialise_fcc_right_half",
    "init_alternating_wells",
    "check_equilibration", "acceptance_fraction", "ensemble_acceptance",
    "hmc_move", "run_hmc", "run_hmc_batch", "run_hmc_equilibration",
    "run_hmc_equilibration_batch", "adjust_eps",
    "HMC_TARGET_ACCEPTANCE", "DEFAULT_NUM_LEAPFROG",
    "temperature_ladder", "init_tempered_state", "run_tempered_moves",
    "swap_replicas", "swap_replicas_replica_sharded", "run_replica_exchange",
    "SwapResult", "ReplicaExchangeResult",
]
