"""Hybrid Algorithm 1: pre-train the flow once, then sample with big moves.

Re-design of ``hybrid_NF_MCMC/main_algorithm_1.py``:

  Phase A  init + equilibrate chains           (ref :136-229)
  Phase B  collect training configs, center    (ref :240-253)
  Phase C  build + train the flow (fwd KLD)    (ref :276-327)
  Phase D  testing: per chain, {BIG_MOVE_INTERVAL local steps, then one
           flow big move with a unique sample} x BIG_MOVE_ATTEMPTS
           (ref :375-422), acceptance history + well stats + ΔF
           (ref :424-548)

Key structural improvements over the reference (SURVEY.md §3.5/§7):
* sample collection, training, and the entire testing loop are jitted device
  programs; chains advance in lockstep as one batch;
* each big-move round evaluates ALL chains' proposals/energies/log-probs in
  a single device batch instead of one torch call per chain;
* the flow model quirk at ref :282 (NUM_BINS passed positionally as
  num_blocks) is fixed — ``n_blocks`` really is the residual-block count.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis.plots import (
    plot_acceptance_rate, plot_avg_free_energy, plot_avg_x_coordinate,
    plot_frequency_heatmap, plot_loss, plot_multiple_avg_x_coordinates,
    plot_pair_correlation, plot_well_statistics,
)
from flowstate.analysis.rdf import calculate_pair_correlation
from flowstate.analysis.wells import calculate_well_statistics
from flowstate.experiments.common import (
    build_system, dump_run_artifacts, init_and_equilibrate, plot_wells,
    setup_experiment,
)
from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    apply_big_moves, run_moves, run_production_batch, to_box_frame,
)
from flowstate.training import TrainConfig, train
from flowstate.utils.config import ExperimentConfig, algorithm1_config


def collect_training_samples(config: ExperimentConfig, spec, state):
    """Phase B: production across chains until the training budget is met.

    production_runs per chain = TRAIN_SAMPLES / C * freq moves total
    (the reference computes ``production_runs`` at :242 then samples every
    SAMPLING_FREQUENCY; equivalently each chain contributes
    TRAIN_SAMPLES / C samples).
    """
    samples_per_chain = config.initial_training_num_samples // config.num_chains
    state, obs = run_production_batch(spec, config.beta, state,
                                      samples_per_chain,
                                      config.sampling_frequency)
    # (C, T, N, 2) -> (C*T, N, 2), then shift to the centered NF frame
    configs_mc = np.asarray(obs.positions).reshape(
        -1, config.num_particles, 2)
    configs_nf = configs_mc - config.half_box  # ref :253
    return state, configs_nf, obs


def make_testing_step(config: ExperimentConfig, spec, model):
    """One testing round, jitted: BIG_MOVE_INTERVAL local moves per chain,
    then one big move per chain from a bank of proposals."""

    @jax.jit
    def testing_round(state, params, proposals_flat, log_q_new, u):
        state = jax.vmap(
            lambda s: run_moves(spec, config.beta, s,
                                config.big_move_interval))(state)
        proposals = to_box_frame(proposals_flat, config.num_particles,
                                 config.half_box)
        result = apply_big_moves(spec, config.beta, state, proposals,
                                 log_q_new, model, params,
                                 config.half_box, u)
        return result.state, result.accepted

    return testing_round


def make_fused_testing(config: ExperimentConfig, spec, model):
    """Phase D as ONE device program: a ``lax.scan`` over all testing
    rounds, each = {BIG_MOVE_INTERVAL local moves, flow proposal + MH big
    move}, emitting (accepted, positions) per round.

    The host-driven loop above pays ~4 host round-trips per round
    (proposal draw, round dispatch, accepted fetch, positions fetch).
    Fused, the full-scale testing phase is one dispatch; same schedule as
    main_algorithm_1.py:375-422, same estimators downstream.
    """
    c = config.num_chains

    @jax.jit
    def run_testing(state, params, key):
        def round_fn(carry, _):
            s, k = carry
            k, k_prop, k_u = jax.random.split(k, 3)
            s = jax.vmap(
                lambda t: run_moves(spec, config.beta, t,
                                    config.big_move_interval))(s)
            prop_flat, log_q_new = model.sample_and_log_prob(
                params, k_prop, c)
            proposals = to_box_frame(prop_flat, config.num_particles,
                                     config.half_box)
            u = jax.random.uniform(k_u, (c,))
            result = apply_big_moves(spec, config.beta, s, proposals,
                                     log_q_new, model, params,
                                     config.half_box, u)
            return (result.state, k), (result.accepted,
                                       result.state.positions)

        (state, _), (accepted, positions) = jax.lax.scan(
            round_fn, (state, key), None, length=config.big_move_attempts)
        return state, accepted, positions

    return run_testing


def make_fused_testing_blocked(config: ExperimentConfig, spec, model,
                               context_fn):
    """Phase D with blocked conditional proposals (``mcmc/blocked.py``):
    each round = {BIG_MOVE_INTERVAL local moves, then one N/k-block sweep
    of blocked moves} — the round-5 schedule that survives N >= 8."""
    from flowstate.mcmc import blocked_big_moves

    bpr = max(1, config.num_particles // config.blocked_k)

    @jax.jit
    def run_testing(state, params, key):
        del key  # blocked moves consume the per-chain streams in state

        def round_fn(s, _):
            s = jax.vmap(
                lambda t: run_moves(spec, config.beta, t,
                                    config.big_move_interval))(s)

            def blk(s2, _):
                res = blocked_big_moves(
                    spec, config.beta, s2, model, params,
                    config.half_box, config.blocked_k,
                    context_fn=context_fn)
                return res.state, res.accepted

            s, accepted = jax.lax.scan(blk, s, None, length=bpr)
            return s, (jnp.mean(accepted.astype(jnp.float32), axis=0),
                       s.positions)

        state, (accepted, positions) = jax.lax.scan(
            round_fn, state, None, length=config.big_move_attempts)
        return state, accepted, positions

    return run_testing


def _use_fused_testing(config: ExperimentConfig) -> bool:
    if config.fused_testing is not None:
        return bool(config.fused_testing)
    pos_bytes = (config.big_move_attempts * config.num_chains
                 * config.num_particles * config.num_dim * 4)
    return pos_bytes < 128 * 1024 * 1024


def run(config: ExperimentConfig,
        premade_data_path: str = None) -> Dict:
    """Run Algorithm 1.

    ``premade_data_path``: optional NPZ of pre-collected configurations
    (centered NF frame, (T, N, 2)) — skips Phase B, the equivalent of the
    reference's ``run_algo_1_v_0.00_premade_data.ipynb`` variant.
    """
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    plot_wells(config, spec, directory)

    # Phase A ------------------------------------------------------------
    state = init_and_equilibrate(config, spec, logger)
    metrics.log("equilibrated", chains=config.num_chains)

    # Phase B ------------------------------------------------------------
    if premade_data_path is not None:
        npz = np.load(premade_data_path)
        arr = npz["configs"] if "configs" in npz.files else npz[npz.files[0]]
        train_configs = np.asarray(arr).reshape(-1, config.num_particles, 2)
        logger.info("loaded %d premade training samples from %s",
                    len(train_configs), premade_data_path)
    else:
        state, train_configs, _ = collect_training_samples(config, spec,
                                                           state)
    logger.info("collected %d training samples", len(train_configs))
    unique = np.unique(train_configs.reshape(len(train_configs), -1), axis=0)
    logger.info("Total unique samples: %d", len(unique))
    metrics.log("samples_collected", total=len(train_configs),
                unique=len(unique))

    # Phase C ------------------------------------------------------------
    blocked = config.blocked_k > 0
    key = jax.random.key(config.master_seed + 1)
    nf_dir = os.path.join(directory, "training_rounds",
                          "initial_training_round")
    os.makedirs(nf_dir, exist_ok=True)
    train_cfg = TrainConfig(batch_size=config.batch_size,
                            epochs=config.epochs, lr=config.lr,
                            weight_decay=config.weight_decay)
    context_fn = None
    if blocked:
        # conditional flow over the k-particle block | the rest
        # (mcmc/blocked.py; invariant Fourier-mode context)
        from flowstate.flows import build_conditional_circular_flow
        from flowstate.mcmc import fourier_context, fourier_context_dim
        from flowstate.training.blocked import train_blocked

        m_max = config.blocked_context_modes
        context_fn = lambda r, p: fourier_context(  # noqa: E731
            r, p, config.half_box, m_max=m_max)
        model = build_conditional_circular_flow(
            config.blocked_k, config.num_dim, config.half_box,
            context_features=fourier_context_dim(m_max),
            K=config.blocked_K, hidden_units=config.hidden_units,
            num_bins=config.num_bins, num_blocks=config.n_blocks)
        params = model.init_params(key)
        logger.info("Conditional model prepared: k=%d block of %d "
                    "particles", config.blocked_k, config.num_particles)
        box_frame = jnp.asarray(
            (train_configs + config.half_box).astype(np.float32))
        params, _, loss_epoch = train_blocked(
            model, params, box_frame, config.blocked_k, config.half_box,
            train_cfg, jax.random.key(config.master_seed + 2),
            context_fn=context_fn)
        for e, l in enumerate(loss_epoch):
            metrics.log("train_epoch", epoch=e, loss=l)
        plot_loss(loss_epoch, nf_dir)
        model.save(params, os.path.join(
            nf_dir, "initial_model_blocked_conditional.pkl"))
    else:
        model = build_circular_flow(
            config.num_particles, config.num_dim, config.half_box,
            K=config.K, hidden_units=config.hidden_units,
            num_bins=config.num_bins, num_blocks=config.n_blocks,
            net_type=config.net_type)
        params = model.init_params(key)
        logger.info("Model prepared with %d particles and %d dimensions!",
                    config.num_particles, config.num_dim)

        data = jnp.asarray(
            train_configs.reshape(len(train_configs), -1).astype(np.float32))
        params, _, loss_hist, loss_epoch = train(
            model, params, data, train_cfg,
            jax.random.key(config.master_seed + 2),
            epoch_callback=lambda e, l: metrics.log("train_epoch", epoch=e,
                                                    loss=l))
        plot_loss(loss_epoch, nf_dir)
        model.save(params, os.path.join(
            nf_dir, "initial_model_circularspline_res_dense.pkl"))

        # post-training model diagnostics (ref :332-360) — unconditional
        # flow only (the conditional model has no context-free sampler)
        eval_samples = model.sample(params, jax.random.key(99),
                                    min(config.num_samples_for_analysis,
                                        50000))
        eval_np = np.asarray(eval_samples).reshape(
            -1, config.num_particles, 2)
        np.save(os.path.join(nf_dir, "samples.npy"),
                eval_np + config.half_box)
        plot_frequency_heatmap(eval_np, nf_dir, config.half_box)
        r_vals, g_r = calculate_pair_correlation(
            eval_np, config.num_particles, config.half_box,
            dr=config.half_box / 50)
        plot_pair_correlation(r_vals, g_r, nf_dir)

    # Phase D ------------------------------------------------------------
    results: Dict = {"directory": directory,
                     "final_loss": loss_epoch[-1] if loss_epoch else None}
    if config.testing:
        c = config.num_chains
        move_key = jax.random.key(config.master_seed + 3)
        if blocked:
            logger.info("testing phase: blocked k=%d fused scan over %d "
                        "rounds", config.blocked_k,
                        config.big_move_attempts)
            run_testing = make_fused_testing_blocked(config, spec, model,
                                                     context_fn)
            state, accepted_rounds, positions_rounds = run_testing(
                state, params, move_key)
            accepted_rounds = np.asarray(accepted_rounds)      # (R, C)
            testing_positions = list(np.asarray(positions_rounds))
            acc_cum = np.cumsum(accepted_rounds.sum(axis=1))
            rounds = np.arange(1, config.big_move_attempts + 1)
            p_acc_history = [0.0] + list(acc_cum / (c * rounds))
            steps_history = [0] + list(rounds * config.big_move_interval * c)
            for r in range(100, config.big_move_attempts + 1, 100):
                metrics.log("big_move_round", round=r,
                            p_acc=p_acc_history[r])
        elif _use_fused_testing(config):
            logger.info("testing phase: fused on-device scan over %d rounds",
                        config.big_move_attempts)
            run_testing = make_fused_testing(config, spec, model)
            state, accepted_rounds, positions_rounds = run_testing(
                state, params, move_key)
            accepted_rounds = np.asarray(accepted_rounds)      # (R, C)
            testing_positions = list(np.asarray(positions_rounds))
            acc_cum = np.cumsum(accepted_rounds.sum(axis=1))
            rounds = np.arange(1, config.big_move_attempts + 1)
            p_acc_history = [0.0] + list(acc_cum / (c * rounds))
            steps_history = [0] + list(rounds * config.big_move_interval * c)
            for r in range(100, config.big_move_attempts + 1, 100):
                metrics.log("big_move_round", round=r,
                            p_acc=p_acc_history[r])
        else:
            testing_round = make_testing_step(config, spec, model)
            p_acc_history = [0.0]
            steps_history = [0]
            total_steps = 0
            big_move_accepts = 0
            big_move_attempts = 0
            testing_positions = []  # (rounds, C, N, 2) snapshots

            for attempt in range(config.big_move_attempts):
                move_key, k_prop, k_u = jax.random.split(move_key, 3)
                prop_flat, log_q_new = model.sample_and_log_prob(
                    params, k_prop, c)
                u = jax.random.uniform(k_u, (c,))
                state, accepted = testing_round(state, params, prop_flat,
                                                log_q_new, u)
                total_steps += config.big_move_interval * c
                big_move_attempts += c
                big_move_accepts += int(np.sum(np.asarray(accepted)))
                p_acc_history.append(big_move_accepts / big_move_attempts)
                steps_history.append(total_steps)
                testing_positions.append(np.asarray(state.positions))
                if (attempt + 1) % 100 == 0:
                    logger.info("big-move round %d/%d: p_acc=%.4f",
                                attempt + 1, config.big_move_attempts,
                                p_acc_history[-1])
                    metrics.log("big_move_round", round=attempt + 1,
                                p_acc=p_acc_history[-1])
        logger.info("testing phase done: p_acc=%.4f", p_acc_history[-1])

        plot_acceptance_rate(p_acc_history, directory,
                             x_values=steps_history, xlabel="MCMC Steps",
                             base_filename="nf_acceptance_rate")
        import csv as _csv
        with open(os.path.join(directory, "acceptance_rate_data.csv"), "w",
                  newline="") as f:
            w = _csv.writer(f)
            w.writerow(["MCMC_Steps", "Acceptance_Rate"])
            for s, a in zip(steps_history, p_acc_history):
                w.writerow([s, a])

        # well statistics over the testing trajectory, per chain
        testing_stack = np.stack(testing_positions, axis=1)  # (C, T, N, 2)
        free_energy_array = []
        for run_idx in range(c):
            avg_x, p_a, p_b, dF, runs = calculate_well_statistics(
                testing_stack[run_idx], 0, config.half_box, config.r0)
            free_energy_array.append(dF)
            run_dir = os.path.join(directory, "mc_runs",
                                   f"run_{run_idx + 1:03d}")
            os.makedirs(run_dir, exist_ok=True)
            if run_idx < 10:
                plot_well_statistics(avg_x, p_a, p_b, dF, runs,
                                     config.half_box, run_dir)
                plot_avg_x_coordinate(testing_stack[run_idx], run_dir,
                                      config.half_box, run_idx + 1)
            np.save(os.path.join(run_dir, "mc_run_testing_configs.npy"),
                    testing_stack[run_idx])

        if c >= 10:
            plot_multiple_avg_x_coordinates(list(testing_stack[:10]),
                                            directory)
        svg, png, fm, fsem, fstd = plot_avg_free_energy(
            np.asarray(free_energy_array), directory)
        logger.info("Final mean delta F = %s", fm)
        logger.info("Final standard error delta F = %s", fsem)

        # Equilibrium-window estimator: discard the first half as burn-in
        # (the reference's cumulative-from-start estimator,
        # utils.py:61-101, carries the 50/50 init transient).
        half = testing_stack.shape[1] // 2
        eq_df = []
        for run_idx in range(c):
            _, p_a, p_b, dF_eq, _ = calculate_well_statistics(
                testing_stack[run_idx], half, config.half_box, config.r0)
            eq_df.append(dF_eq[-1])
        eq_df = np.asarray(eq_df)
        finite = eq_df[np.isfinite(eq_df) & (eq_df != 0.0)]
        eq_mean = float(np.mean(finite)) if len(finite) else float("nan")
        eq_sem = (float(np.std(finite) / np.sqrt(len(finite)))
                  if len(finite) else float("nan"))
        logger.info("Equilibrium-window delta F = %s +- %s", eq_mean, eq_sem)

        # particle-level ΔF = ln(E[n_B]/E[n_A]) over the equilibrium
        # window — the estimator that stays meaningful at N >= 8, where
        # the reference's configuration-classification ΔF degenerates
        # (mixed-sector configs are neither "A" nor "B")
        from flowstate.analysis.wells import classify_particles as _cp
        cls_eq = _cp(testing_stack[:, half:].reshape(
            -1, config.num_particles, 2), config.half_box, config.r0)
        n_a_eq = float(np.sum(cls_eq == 0))
        n_b_eq = float(np.sum(cls_eq == 1))
        df_particle = float(np.log(max(n_b_eq, 1.0) / max(n_a_eq, 1.0)))
        logger.info("Particle-level delta F (eq window) = %.4f",
                    df_particle)
        metrics.log("free_energy", mean=fm, sem=fsem, std=fstd,
                    eq_mean=eq_mean, eq_sem=eq_sem,
                    df_particle=df_particle)
        results.update({"delta_f_mean": fm, "delta_f_sem": fsem,
                        "delta_f_std": fstd,
                        "delta_f_eq_mean": eq_mean,
                        "delta_f_eq_sem": eq_sem,
                        "df_particle": df_particle,
                        "big_move_acceptance": p_acc_history[-1]})
        from flowstate.experiments.common import (
            _thin, sector_counts, write_evidence,
        )
        write_evidence(config, {
            "driver": "algorithm1",
            "delta_f_mean": fm, "delta_f_sem": fsem, "delta_f_std": fstd,
            "delta_f_eq_mean": eq_mean, "delta_f_eq_sem": eq_sem,
            "df_particle": df_particle,
            "delta_f_per_chain_final": [float(f[-1]) if len(f) else None
                                        for f in free_energy_array],
            "big_move_acceptance": p_acc_history[-1],
            "p_acc_history": _thin(p_acc_history),
            "steps_history": _thin(steps_history),
            "sector_counts": sector_counts(testing_stack, config.half_box,
                                           config.r0),
        })
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description="Hybrid Algorithm 1")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="results")
    args, _ = parser.parse_known_args()
    config = algorithm1_config(experiment_id=args.experiment_id,
                               output_dir=args.output_dir)
    run(config)


if __name__ == "__main__":
    main()
