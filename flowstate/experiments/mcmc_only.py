"""Baseline MCMC-only driver.

Re-design of ``hybrid_NF_MCMC/main_mcmc_only.py``: the
reference's 100 sequential "parallel" chains (main_mcmc_only.py:33,
110-158) become one vmapped batch; the production loop runs on device and
the analysis (well statistics, ΔF with SEM band, per-run plots, CSV/NPY
dumps, main_mcmc_only.py:218-325) runs on the host over the returned
sample stacks.

The reference's float-``range()`` crash (``PRODUCTION_STEPS`` is a float at
main_mcmc_only.py:56-57 — SURVEY.md §7 documented bug) is fixed by integer
division of the step budget.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import jax.numpy as jnp
import numpy as np

from flowstate.analysis.plots import (
    plot_avg_free_energy, plot_avg_x_coordinate,
    plot_multiple_avg_x_coordinates, plot_state_histogram,
    plot_well_statistics,
)
from flowstate.analysis.wells import (
    calculate_well_statistics, classify_particles,
)
from flowstate.experiments.common import (
    build_system, dump_run_artifacts, init_and_equilibrate, plot_wells,
    sector_counts, setup_experiment, write_evidence,
)
from flowstate.mcmc import (
    run_hmc, run_hmc_equilibration_batch, run_mala,
    run_mala_equilibration_batch, run_moves, run_production_with_batch,
)
from flowstate.utils.config import ExperimentConfig, mcmc_only_config


def run(config: ExperimentConfig,
        total_production_steps: int = 10_000_000) -> Dict:
    """Run the baseline experiment; returns a results summary dict."""
    # validate up front: failing after setup_experiment + a long
    # equilibration would waste the run and leave an orphaned output dir
    if config.sampler not in ("metropolis", "mala", "hmc"):
        raise ValueError(f"unknown sampler {config.sampler!r}")
    if config.sampler == "hmc" and config.num_leapfrog < 1:
        raise ValueError(
            f"num_leapfrog must be >= 1, got {config.num_leapfrog}")
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    plot_wells(config, spec, directory)

    state = init_and_equilibrate(config, spec, logger)
    metrics.log("equilibrated", chains=config.num_chains,
                steps=config.equilibration_steps)

    # beyond-reference move kernels need their own step-size scale: the
    # Metropolis displacement is not a Langevin/leapfrog eps, so re-adapt
    # from the sampler_bench.py starting points before production.
    if config.sampler in ("mala", "hmc"):
        # kernel swap: reset the step size AND the adaptation baseline —
        # leftover Metropolis attempts/accepts since the last adjust would
        # otherwise skew the first tau/eps adaptation block
        swap_disp = 0.02 if config.sampler == "mala" else 0.05
        state = state._replace(
            max_disp=jnp.full_like(state.max_disp, swap_disp),
            prev_attempts=state.attempts, prev_accepts=state.accepts)
    if config.sampler == "mala":
        state = run_mala_equilibration_batch(spec, config.beta, state,
                                             1000, 100)
        metrics.log("mala_adapted", eps_mean=float(state.max_disp.mean()))
    elif config.sampler == "hmc":
        state = run_hmc_equilibration_batch(spec, config.beta, state,
                                            500, 50, config.num_leapfrog)
        metrics.log("hmc_adapted", eps_mean=float(state.max_disp.mean()))

    # production: total budget split over chains (int division fixes the
    # reference's float range() bug)
    steps_per_chain = int(total_production_steps) // config.num_chains
    num_samples = steps_per_chain // config.sampling_frequency
    logger.info("production: %d steps/chain -> %d samples/chain (%s)",
                steps_per_chain, num_samples, config.sampler)
    if config.sampler == "mala":
        move_fn = lambda s, n: run_mala(spec, config.beta, s, n)  # noqa: E731
    elif config.sampler == "hmc":
        # gradient-evaluation budget: n local moves -> n/num_leapfrog
        # trajectories (each costs num_leapfrog+1 grads; SAMPLERS.md)
        move_fn = lambda s, n: run_hmc(  # noqa: E731
            spec, config.beta, s, max(1, n // config.num_leapfrog),
            config.num_leapfrog)
    else:
        move_fn = lambda s, n: run_moves(spec, config.beta, s, n)  # noqa: E731
    att0 = int(jnp.sum(state.attempts))
    acc0 = int(jnp.sum(state.accepts))
    state, obs = run_production_with_batch(spec, config.beta, state,
                                           num_samples,
                                           config.sampling_frequency, move_fn)
    configs = np.asarray(obs.positions)  # (C, T, N, 2)
    prod_att = int(jnp.sum(state.attempts)) - att0
    prod_acceptance = ((int(jnp.sum(state.accepts)) - acc0) / prod_att
                       if prod_att else float("nan"))
    metrics.log("production_done", steps_per_chain=steps_per_chain,
                samples_per_chain=num_samples,
                production_acceptance=prod_acceptance)

    # per-run well statistics + ΔF
    free_energy_array = []
    for run_idx in range(config.num_chains):
        avg_x, p_a, p_b, dF, runs = calculate_well_statistics(
            configs[run_idx], 0, config.half_box, config.r0)
        free_energy_array.append(dF)
        run_dir = os.path.join(directory, "mc_runs",
                               f"run_{run_idx + 1:03d}")
        os.makedirs(run_dir, exist_ok=True)
        if run_idx < 10:
            plot_well_statistics(avg_x, p_a, p_b, dF, runs,
                                 config.half_box, run_dir)
            plot_avg_x_coordinate(configs[run_idx], run_dir,
                                  config.half_box, run_idx + 1)
        obs_i = type(obs)(*[np.asarray(leaf[run_idx]) for leaf in obs])
        dump_run_artifacts(directory, run_idx, obs_i, None)

    plot_multiple_avg_x_coordinates(list(configs[:10]), directory)
    svg, png, final_mean, final_sem, final_std = plot_avg_free_energy(
        np.asarray(free_energy_array), directory)
    logger.info("Final mean delta F = %s +- %s", final_mean, final_sem)
    metrics.log("free_energy", mean=final_mean, sem=final_sem, std=final_std)

    cls = classify_particles(configs.reshape(-1, config.num_particles, 2),
                             config.half_box, config.r0)
    plot_state_histogram(cls, directory)

    write_evidence(config, {
        "driver": "mcmc_only",
        "sampler": config.sampler,
        "total_production_steps": int(total_production_steps),
        "samples_per_chain": num_samples,
        "delta_f_mean": final_mean, "delta_f_sem": final_sem,
        "delta_f_std": final_std,
        "delta_f_per_chain_final": [float(f[-1]) if len(f) else None
                                    for f in free_energy_array],
        "production_acceptance": prod_acceptance,
        "sector_counts": sector_counts(configs, config.half_box, config.r0),
    })

    return {"delta_f_mean": final_mean, "delta_f_sem": final_sem,
            "delta_f_std": final_std, "directory": directory,
            "samples_per_chain": num_samples,
            "production_acceptance": prod_acceptance}


def main() -> None:
    parser = argparse.ArgumentParser(description="Baseline MCMC experiment")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--num_chains", type=int, default=100)
    parser.add_argument("--total_steps", type=int, default=10_000_000)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--sampler", type=str, default="metropolis",
                        choices=("metropolis", "mala", "hmc", "pt"),
                        help="production move kernel (mala/hmc are "
                             "beyond-reference gradient samplers; pt = "
                             "parallel tempering, dispatched to the "
                             "experiments.tempering driver — the "
                             "recommended sampler for N >= 8)")
    parser.add_argument("--num_leapfrog", type=int, default=10)
    args = parser.parse_args()
    if args.sampler == "pt":
        from flowstate.experiments import tempering
        from flowstate.utils.config import tempering_config
        config = tempering_config(experiment_id=args.experiment_id,
                                  num_chains=args.num_chains,
                                  output_dir=args.output_dir)
        tempering.run(config, total_production_steps=args.total_steps)
        return
    config = mcmc_only_config(experiment_id=args.experiment_id,
                              num_chains=args.num_chains,
                              output_dir=args.output_dir,
                              sampler=args.sampler,
                              num_leapfrog=args.num_leapfrog)
    run(config, total_production_steps=args.total_steps)


if __name__ == "__main__":
    main()
