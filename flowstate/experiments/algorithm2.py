"""Hybrid Algorithm 2: interleave MCMC production, flow retraining, big moves.

Re-design of ``hybrid_NF_MCMC/main_algorithm_2.py``:

  init + equilibrate chains, collect a small initial train set (ref :240-277)
  build the flow with a DoubleWellLJ energy target attached (ref :281-295)
  initial training with the mixed loss
      alpha * forward_kld + (1 - alpha) * reverse_kld        (ref :314-331)
  then NUM_TRAINING_CYCLES x  {                              (ref :393-577)
      produce UPDATE_NUM_SAMPLES new samples across chains   (:399-418)
      sliding-window or cumulative train set                 (:421-432)
      fresh optimizer + EPOCHS retrain                       (:437-456)
      periodic checkpoints / eval plots                      (:459-526)
      one flow big move per chain                            (:534-548)
      acceptance bookkeeping                                 (:550-577)
  }
  final ΔF over the last NUMBER_OF_SAMPLES_FOR_FREE_ENERGY samples
  (ref :74-76, 620-671) and the p_acc-vs-training-samples curve (:588-610).

Notes vs the reference (SURVEY.md §7): the ALPHA=1.0 dead reverse-KLD
compute (ref :52, 319-321) is not replicated — the energy term is only
evaluated when alpha < 1; checkpoints capture the full experiment state
(flow + optimizer + chains + keys), not just flow weights.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis.plots import (
    plot_acceptance_rate, plot_avg_free_energy, plot_frequency_heatmap,
    plot_loss, plot_pair_correlation, plot_well_statistics,
)
from flowstate.analysis.rdf import calculate_pair_correlation
from flowstate.analysis.wells import calculate_well_statistics
from flowstate.experiments.common import (
    _thin, build_system, init_and_equilibrate, plot_wells, sector_counts,
    setup_experiment, write_evidence,
)
from flowstate.flows import DoubleWellLJ, build_circular_flow
from flowstate.mcmc import apply_big_moves, run_production_batch, to_box_frame
from flowstate.training import (
    TrainConfig, sliding_window_update, train,
)
from flowstate.utils.checkpoint import save_checkpoint
from flowstate.utils.config import ExperimentConfig, algorithm2_config


def run(config: ExperimentConfig, resume: bool = False,
        fused: bool = False, freeze_after: Optional[int] = None) -> Dict:
    blocked = config.blocked_k > 0
    if blocked and fused:
        raise ValueError("blocked_k is only supported by the host-driven "
                         "cycle loop (fused=False)")
    if blocked and config.alpha < 1.0:
        raise ValueError("the mixed (reverse-KLD) loss has no conditional "
                         "form; blocked_k requires alpha=1.0")
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    plot_wells(config, spec, directory)

    state = init_and_equilibrate(config, spec, logger)
    metrics.log("equilibrated", chains=config.num_chains)

    start_cycle = 0
    restored = None
    if resume:
        from flowstate.mcmc import ChainState
        from flowstate.utils.checkpoint import (
            latest_checkpoint, restore_checkpoint,
        )
        ckpt = latest_checkpoint(os.path.join(directory, "checkpoints"))
        if ckpt is not None:
            step, path = ckpt
            logger.info("resuming from checkpoint %s (cycle %d)", path, step)
            restored = (step, path)

    # initial (small) training set -- ref :240-277
    # (skipped on resume: the restored chain/flow state supersedes it)
    samples_per_chain = max(
        1, config.initial_training_num_samples // config.num_chains)
    if restored is None:
        state, obs = run_production_batch(spec, config.beta, state,
                                          samples_per_chain,
                                          config.sampling_frequency)
        train_set = (np.asarray(obs.positions).reshape(
            -1, config.num_particles, 2) - config.half_box).reshape(
                -1, config.dim).astype(np.float32)
    else:
        train_set = np.zeros((config.update_num_samples, config.dim),
                             dtype=np.float32)  # replaced in cycle 1
    logger.info("initial train set: %d samples", len(train_set))

    # model with the energy target attached -- ref :281-295
    if blocked:
        # conditional block flow (the round-5 N-wall sampler): trained by
        # conditional MLE, so no energy target is attached
        from flowstate.flows import build_conditional_circular_flow
        from flowstate.mcmc import fourier_context, fourier_context_dim

        m_max = config.blocked_context_modes
        context_fn = lambda r, p: fourier_context(  # noqa: E731
            r, p, config.half_box, m_max=m_max)
        model = build_conditional_circular_flow(
            config.blocked_k, config.num_dim, config.half_box,
            context_features=fourier_context_dim(m_max),
            K=config.blocked_K, hidden_units=config.hidden_units,
            num_bins=config.num_bins, num_blocks=config.n_blocks)
    else:
        context_fn = None
        target = DoubleWellLJ(dim=config.dim,
                              n_particles=config.num_particles,
                              temperature=config.temperature,
                              bound=config.half_box,
                              V0_list=tuple(config.V0_list[:2]),
                              r0=config.r0, k=config.k_val)
        model = build_circular_flow(
            config.num_particles, config.num_dim, config.half_box,
            K=config.K, hidden_units=config.hidden_units,
            num_bins=config.num_bins, num_blocks=config.n_blocks,
            net_type=config.net_type, target=target)
    params = model.init_params(jax.random.key(config.master_seed + 1))

    def retrain(params, train_set, key):
        """One (re)training pass; train_set is centered flat (S, dim)."""
        if blocked:
            from flowstate.training.blocked import train_blocked
            configs = jnp.asarray(train_set).reshape(
                -1, config.num_particles, 2) + config.half_box
            params, _, loss_epoch = train_blocked(
                model, params, configs, config.blocked_k, config.half_box,
                train_cfg, key, context_fn=context_fn)
            return params, loss_epoch
        params, _, _, loss_epoch = train(model, params,
                                         jnp.asarray(train_set),
                                         train_cfg, key)
        return params, loss_epoch

    if restored is not None:
        from flowstate.mcmc import ChainState
        from flowstate.utils.checkpoint import restore_checkpoint
        start_cycle, path = restored
        example = {"flow": params, "chains": state._asdict()}
        tree, _ = restore_checkpoint(path, example)
        params = tree["flow"]
        state = ChainState(**tree["chains"])

    train_cfg = TrainConfig(batch_size=config.batch_size,
                            epochs=config.epochs, lr=config.lr,
                            weight_decay=config.weight_decay,
                            alpha=config.alpha)

    # initial training -- ref :314-331 (skipped on resume)
    if restored is None:
        params, loss_epoch = retrain(
            params, train_set, jax.random.key(config.master_seed + 2))
        loss_per_cycle = list(loss_epoch)
    else:
        loss_per_cycle = []

    # the on-the-fly cycle loop -- ref :393-577
    c = config.num_chains
    p_acc_history = [0.0]
    training_samples_history = [len(train_set)]
    big_move_accepts = 0
    big_move_attempts = 0
    production_configs = [[] for _ in range(c)]  # per-chain sampled configs
    # fold the proposal-key stream by the starting cycle so a resumed run
    # does not replay cycle 0's keys against late-cycle state
    move_key = jax.random.fold_in(jax.random.key(config.master_seed + 3),
                                  start_cycle)

    new_samples_per_chain = max(
        1, config.update_num_samples // config.num_chains)

    if fused:
        # entire cycle chunks run on device (training/cycles.py); the host
        # syncs once per checkpoint period for metrics/plots/checkpoints
        from flowstate.training.cycles import make_fused_cycles

        chunk = config.checkpoint_interval * 2
        runners: Dict = {}

        def get_runner(n: int, do_train: bool):
            if (n, do_train) not in runners:
                runners[(n, do_train)] = make_fused_cycles(
                    model, spec, config, n, train=do_train)
            return runners[(n, do_train)]

        cycle = start_cycle
        while cycle < config.num_training_cycles:
            n = min(chunk, config.num_training_cycles - cycle)
            # finite-adaptation: chunks never straddle the freeze boundary
            do_train = freeze_after is None or cycle < freeze_after
            if do_train and freeze_after is not None:
                n = min(n, freeze_after - cycle)
            r = get_runner(n, do_train)
            params, state, move_key, out = r(params, state, move_key)
            losses = np.asarray(out["loss"])           # (n, epochs)
            accepts = np.asarray(out["accepts"])       # (n,)
            pos = np.asarray(out["positions"])         # (n, C, T, N, 2)
            for j in range(n):
                if do_train:
                    loss_per_cycle.extend(losses[j].tolist())
                big_move_attempts += c
                big_move_accepts += int(accepts[j])
                p_acc_history.append(big_move_accepts / big_move_attempts)
                training_samples_history.append(
                    len(train_set) if cycle + j == 0 else
                    config.update_num_samples)
            for i in range(c):
                production_configs[i].append(
                    pos[:, i].reshape(-1, config.num_particles, 2))
            cycle += n
            plot_loss(loss_per_cycle, directory, base_filename="loss_plot")
            metrics.log("cycle", cycle=cycle,
                        loss=float(losses[-1][-1]) if do_train else None,
                        frozen=not do_train,
                        train_set=config.update_num_samples,
                        p_acc=p_acc_history[-1])
            save_checkpoint(
                os.path.join(directory, "checkpoints"), cycle,
                {"flow": params, "chains": state._asdict()},
                metadata={"cycle": cycle,
                          "train_set_size": config.update_num_samples})
            eval_n = min(config.num_samples_for_analysis, 50000)
            ev = np.asarray(model.sample(
                params, jax.random.fold_in(move_key, 17), eval_n)).reshape(
                    -1, config.num_particles, 2)
            plot_frequency_heatmap(ev, directory, config.half_box,
                                   base_filename=f"heatmap_cycle_{cycle}")
            r_vals, g_r = calculate_pair_correlation(
                ev[:5000], config.num_particles, config.half_box)
            plot_pair_correlation(r_vals, g_r, directory,
                                  base_filename=f"rdf_cycle_{cycle}")

    unfused_cycles = 0 if fused else config.num_training_cycles
    for cycle in range(start_cycle, unfused_cycles):
        # 1) production -- ref :399-418
        state, obs = run_production_batch(spec, config.beta, state,
                                          new_samples_per_chain,
                                          config.sampling_frequency)
        new_mc = np.asarray(obs.positions)  # (C, T, N, 2)
        for i in range(c):
            production_configs[i].append(new_mc[i])
        new_nf = (new_mc.reshape(-1, config.num_particles, 2)
                  - config.half_box).reshape(-1, config.dim).astype(np.float32)

        if freeze_after is None or cycle < freeze_after:
            # 2) train-set policy -- ref :421-432
            train_set = sliding_window_update(
                train_set, new_nf,
                cumulative=config.cumulative_training_samples)

            # 3) fresh optimizer + retrain -- ref :437-456
            params, loss_epoch = retrain(
                params, train_set,
                jax.random.fold_in(
                    jax.random.key(config.master_seed + 4), cycle))
            loss_per_cycle.extend(loss_epoch)
        else:  # finite-adaptation: flow frozen, chain kernel now fixed
            loss_epoch = []

        # 4) periodic checkpoint / eval -- ref :459-526
        if (cycle + 1) % config.checkpoint_interval == 0:
            plot_loss(loss_per_cycle, directory, base_filename="loss_plot")
            metrics.log("cycle", cycle=cycle + 1,
                        loss=loss_epoch[-1] if loss_epoch else None,
                        train_set=len(train_set),
                        p_acc=p_acc_history[-1])
        if (cycle + 1) % (config.checkpoint_interval * 2) == 0:
            save_checkpoint(
                os.path.join(directory, "checkpoints"), cycle + 1,
                {"flow": params, "chains": state._asdict()},
                metadata={"cycle": cycle + 1,
                          "train_set_size": len(train_set)})
            if not blocked:   # the conditional model has no context-free
                eval_n = min(config.num_samples_for_analysis, 50000)
                ev = np.asarray(model.sample(
                    params, jax.random.fold_in(move_key, 17),
                    eval_n)).reshape(-1, config.num_particles, 2)
                plot_frequency_heatmap(
                    ev, directory, config.half_box,
                    base_filename=f"heatmap_cycle_{cycle+1}")
                r_vals, g_r = calculate_pair_correlation(
                    ev[:5000], config.num_particles, config.half_box)
                plot_pair_correlation(r_vals, g_r, directory,
                                      base_filename=f"rdf_cycle_{cycle+1}")

        # 5) one big move per chain -- ref :534-548 (blocked_k > 0: one
        #    N/k block sweep of conditional moves, mcmc/blocked.py)
        if blocked:
            from flowstate.mcmc import blocked_big_moves

            bpr = max(1, config.num_particles // config.blocked_k)
            accepted_frac = 0.0
            for _ in range(bpr):
                result = blocked_big_moves(
                    spec, config.beta, state, model, params,
                    config.half_box, config.blocked_k,
                    context_fn=context_fn)
                state = result.state
                accepted_frac += float(
                    np.mean(np.asarray(result.accepted))) / bpr
            big_move_attempts += c
            big_move_accepts += accepted_frac * c
        else:
            move_key, k_prop, k_u = jax.random.split(move_key, 3)
            prop_flat, log_q_new = model.sample_and_log_prob(params,
                                                             k_prop, c)
            proposals = to_box_frame(prop_flat, config.num_particles,
                                     config.half_box)
            u = jax.random.uniform(k_u, (c,))
            result = apply_big_moves(spec, config.beta, state, proposals,
                                     log_q_new, model, params,
                                     config.half_box, u)
            state = result.state
            big_move_attempts += c
            big_move_accepts += int(np.sum(np.asarray(result.accepted)))
        p_acc_history.append(big_move_accepts / big_move_attempts)
        training_samples_history.append(len(train_set))

    # final analysis -- ref :588-671
    plot_acceptance_rate(p_acc_history, directory,
                         x_values=training_samples_history,
                         xlabel="Training samples seen",
                         base_filename="p_acc_vs_training_samples")

    results: Dict = {"directory": directory,
                     "big_move_acceptance": p_acc_history[-1]}
    if config.num_training_cycles > 0:
        # persist the raw production trajectories: (C, total_T, N, 2) —
        # the state-sector analysis (well SECTOR occupancies vs the exact
        # quadrature, tools/sector_check.py) re-reads them
        all_traj = np.stack([np.concatenate(production_configs[i], axis=0)
                             for i in range(c)])
        np.save(os.path.join(directory, "production_positions.npy"),
                all_traj.astype(np.float32))
        free_energy_array = []
        for i in range(c):
            traj = np.concatenate(production_configs[i], axis=0)
            start = max(0, len(traj) - config.num_samples_for_free_energy)
            avg_x, p_a, p_b, dF, runs = calculate_well_statistics(
                traj, start, config.half_box, config.r0)
            free_energy_array.append(dF)
            if i < 10:
                run_dir = os.path.join(directory, "mc_runs",
                                       f"run_{i + 1:03d}")
                os.makedirs(run_dir, exist_ok=True)
                plot_well_statistics(avg_x, p_a, p_b, dF, runs,
                                     config.half_box, run_dir)
        min_len = min(len(f) for f in free_energy_array)
        fe = np.asarray([f[:min_len] for f in free_energy_array])
        svg, png, fm, fsem, fstd = plot_avg_free_energy(fe, directory)
        logger.info("Final mean delta F = %s +- %s", fm, fsem)
        metrics.log("free_energy", mean=fm, sem=fsem, std=fstd)
        results.update({"delta_f_mean": fm, "delta_f_sem": fsem,
                        "delta_f_std": fstd})
        write_evidence(config, {
            "driver": "algorithm2",
            "fused": fused, "freeze_after": freeze_after,
            "resumed_from_cycle": start_cycle,
            "delta_f_mean": fm, "delta_f_sem": fsem, "delta_f_std": fstd,
            "delta_f_per_chain_final": [float(f[-1]) if len(f) else None
                                        for f in free_energy_array],
            "big_move_acceptance": p_acc_history[-1],
            "p_acc_history": _thin(p_acc_history),
            "loss_per_cycle": _thin(loss_per_cycle),
            "training_samples_history": _thin(training_samples_history),
            "sector_counts": sector_counts(all_traj, config.half_box,
                                           config.r0),
        })
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description="Hybrid Algorithm 2")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest checkpoint")
    parser.add_argument("--fused", action="store_true",
                        help="run cycle chunks fully on device "
                             "(training/cycles.py) — requires the "
                             "non-cumulative alpha=1 full-scale regime")
    parser.add_argument("--freeze_after", type=int, default=None,
                        help="finite adaptation: stop retraining the flow "
                             "after this many cycles; the remaining cycles "
                             "sample with a FIXED kernel (detailed balance "
                             "holds exactly, no adaptation bias)")
    args, _ = parser.parse_known_args()
    config = algorithm2_config(experiment_id=args.experiment_id,
                               output_dir=args.output_dir)
    run(config, resume=args.resume, fused=args.fused,
        freeze_after=args.freeze_after)


if __name__ == "__main__":
    main()
