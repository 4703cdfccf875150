"""Parallel-tempering production driver.

Promotes PT from a library capability (``mcmc/tempering.py``) to a full
experiment driver with the same surface as the baseline MCMC driver
(driver shape: ``hybrid_NF_MCMC/main_mcmc_only.py:33-59``): per-walker
well statistics and ΔF with SEM band, plots, CSV/evidence dumps,
params.json — plus the beyond-reference pieces PT enables: an MBAR ΔF
that pools EVERY replica's samples (``analysis/mbar.py``), edge-acceptance
diagnostics, and true checkpoint/resume.

This is the production sampler RESULTS.md recommends for N >= 8, where
the global flow proposal hits the measured acceptance wall — so unlike
the reference driver it exposes the particle count as a first-class flag.

Execution shape: the PT loop runs in jitted SEGMENTS of
``pt_segment_rounds`` exchange rounds (one ``run_replica_exchange`` scan
per segment).  After each segment the full tempered ``ChainState`` is
checkpointed (Orbax) and the segment's observables — cold-replica
positions, per-replica well counts and energies, computed ON DEVICE by a
``record_fn`` — land in ``segments/seg_XXXX.npz``.  ``--resume`` restores
the newest checkpoint and re-reads the finished segments' observables, so
a killed run continues bit-exactly (per-segment PRNG keys are folded from
the master seed by segment index).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis.mbar import mbar_free_energies, mbar_log_weights
from flowstate.analysis.plots import (
    plot_avg_free_energy, plot_avg_x_coordinate,
    plot_multiple_avg_x_coordinates, plot_state_histogram,
    plot_well_statistics,
)
from flowstate.analysis.wells import (
    calculate_well_statistics, classify_particles, well_counts_device,
)
from flowstate.experiments.common import (
    build_system, plot_wells, sector_counts, setup_experiment,
    write_evidence,
)
from flowstate.mcmc import (
    init_tempered_state, run_equilibration, run_replica_exchange,
    temperature_ladder,
)
from flowstate.mcmc.initialise import init_split_wells
from flowstate.utils.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from flowstate.utils.config import ExperimentConfig, tempering_config


def _segment_paths(directory: str):
    return sorted(glob.glob(os.path.join(directory, "segments",
                                         "seg_*.npz")))


def run(config: ExperimentConfig,
        total_production_steps: int = 10_000_000,
        resume: bool = False) -> Dict:
    """Run the PT experiment; returns a results summary dict."""
    if config.sampler != "pt":
        raise ValueError(f"tempering driver requires sampler='pt', got "
                         f"{config.sampler!r}")
    if config.pt_replicas < 2:
        raise ValueError("pt_replicas must be >= 2")
    directory, logger, metrics = setup_experiment(config)
    spec = build_system(config)
    plot_wells(config, spec, directory)
    os.makedirs(os.path.join(directory, "segments"), exist_ok=True)

    r, w, n = config.pt_replicas, config.num_chains, config.num_particles
    betas = temperature_ladder(config.temperature, config.pt_t_hot, r,
                               config.pt_ladder)
    mpr = config.pt_moves_per_round
    # budget accounting matches the baseline driver: total/walkers local
    # moves at the COLD temperature per walker (the ladder costs R x that
    # on device; it buys the crossings — that is the product)
    rounds_total = (int(total_production_steps) // w) // mpr
    seg_len = min(config.pt_segment_rounds, max(rounds_total, 1))
    num_segments = max(1, rounds_total // seg_len)
    logger.info("PT: %d replicas x %d walkers, T in [%g, %g], "
                "%d rounds x %d moves (%d segments of %d)",
                r, w, config.temperature, config.pt_t_hot,
                num_segments * seg_len, mpr, num_segments, seg_len)

    # ---- init + per-replica equilibration ------------------------------
    pos, _ = init_split_wells(w, n, config.rho)
    state = init_tempered_state(
        spec, jnp.broadcast_to(jnp.asarray(pos), (r, w, n, 2)),
        jax.random.key(config.master_seed),
        config.initial_max_displacement)

    ckpt_dir = os.path.join(directory, "checkpoints")
    seg_done = 0
    if resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            seg_done, path = latest
            state, _ = restore_checkpoint(path, jax.device_get(state))
            state = jax.tree_util.tree_map(jnp.asarray, state)
            logger.info("resumed from %s (%d segments done)", path,
                        seg_done)
    if seg_done == 0:
        state = jax.jit(jax.vmap(lambda b, s: jax.vmap(
            lambda t: run_equilibration(
                spec, b, t, config.equilibration_steps,
                config.adjusting_frequency))(s)))(betas, state)
        jax.block_until_ready(state.energy)
        metrics.log("equilibrated", replicas=r, walkers=w,
                    steps=config.equilibration_steps)

    # ---- segmented production loop -------------------------------------
    @jax.jit
    def segment(st, key):
        return run_replica_exchange(
            spec, betas, st, key, seg_len, mpr, record="cold",
            record_fn=lambda s: (
                *well_counts_device(s.positions, config.half_box,
                                    config.r0),
                s.energy))

    master = jax.random.key(config.master_seed + 1)
    for seg in range(seg_done, num_segments):
        t0 = time.perf_counter()
        res = segment(state, jax.random.fold_in(master, seg))
        state = res.state
        na, nb, e_all = res.extras
        seg_path = os.path.join(directory, "segments",
                                f"seg_{seg:04d}.npz")
        np.savez_compressed(
            seg_path,
            cold_positions=np.asarray(res.cold_positions,
                                      dtype=np.float32),
            n_a=np.asarray(na, dtype=np.int16),
            n_b=np.asarray(nb, dtype=np.int16),
            energy=np.asarray(e_all, dtype=np.float32),
            edge_acceptance=np.asarray(res.edge_acceptance))
        save_checkpoint(ckpt_dir, seg + 1, jax.device_get(state),
                        metadata={"segment": seg + 1,
                                  "rounds_done": (seg + 1) * seg_len})
        dt = time.perf_counter() - t0
        metrics.log("segment_done", segment=seg + 1,
                    of=num_segments, wall_s=round(dt, 2),
                    edge_acceptance=[round(float(a), 3)
                                     for a in np.asarray(
                                         res.edge_acceptance)])
        logger.info("segment %d/%d done (%.1f s)", seg + 1, num_segments,
                    dt)

    # ---- gather observables --------------------------------------------
    segs = [np.load(p) for p in _segment_paths(directory)]
    cold_pos = np.concatenate([s["cold_positions"] for s in segs])
    na = np.concatenate([s["n_a"] for s in segs])         # (T, R, W)
    nb = np.concatenate([s["n_b"] for s in segs])
    e_all = np.concatenate([s["energy"] for s in segs])   # (T, R, W)
    edge_acc = np.mean(np.stack([s["edge_acceptance"] for s in segs]),
                       axis=0)
    t_rounds = cold_pos.shape[0]
    burn = t_rounds // 3

    # per-walker well statistics + ΔF (the reference's per-run analysis,
    # main_mcmc_only.py:218-271, on the cold-replica trajectory)
    configs_w = cold_pos.transpose(1, 0, 2, 3)            # (W, T, N, 2)
    free_energy_array = []
    for run_idx in range(w):
        avg_x, p_a, p_b, d_f, runs = calculate_well_statistics(
            configs_w[run_idx], 0, config.half_box, config.r0)
        free_energy_array.append(d_f)
        if run_idx < 10:
            run_dir = os.path.join(directory, "mc_runs",
                                   f"run_{run_idx + 1:03d}")
            os.makedirs(run_dir, exist_ok=True)
            plot_well_statistics(avg_x, p_a, p_b, d_f, runs,
                                 config.half_box, run_dir)
            plot_avg_x_coordinate(configs_w[run_idx], run_dir,
                                  config.half_box, run_idx + 1)
    plot_multiple_avg_x_coordinates(list(configs_w[:10]), directory)
    svg, png, final_mean, final_sem, final_std = plot_avg_free_energy(
        np.asarray(free_energy_array), directory)
    logger.info("Final mean delta F = %s +- %s (occupancy, cold replica)",
                final_mean, final_sem)

    # cold-replica particle-level ΔF (the N-scaling oracle convention)
    df_cold = float(np.log(max(nb[burn:, 0].sum(), 1.0)
                           / max(na[burn:, 0].sum(), 1.0)))
    # sector ΔF = ln(P(all B)/P(all A)) — the TEMPERING.md / exact-
    # quadrature convention (all-A and all-B flags fall out of the
    # recorded counts: n_a == N / n_b == N)
    all_a = (na == n)
    all_b = (nb == n)
    df_sector_cold = float(np.log(max(all_b[burn:, 0].sum(), 1.0)
                                  / max(all_a[burn:, 0].sum(), 1.0)))

    # MBAR over the whole post-burn ladder (x64: repo convention for ΔF
    # analysis — fp32 logsumexp error is comparable to the SEM).  Round-
    # stride thinning caps the pool at ~500k samples: beyond that the
    # f64 self-consistent iteration costs minutes of emulated-f64 device
    # time for no ΔF precision gain (the samples are round-correlated)
    stride = max(1, (t_rounds - burn) * r * w // 500_000)
    na_t, nb_t, e_t = (a[burn:][::stride] for a in (na, nb, e_all))
    all_a_t, all_b_t = all_a[burn:][::stride], all_b[burn:][::stride]
    e_pool = e_t.transpose(1, 0, 2).reshape(r, -1)        # (R, M)
    m = e_pool.shape[1]
    with jax.enable_x64(True):
        u_kn = (jnp.asarray(betas, jnp.float64)[:, None]
                * jnp.asarray(e_pool.reshape(-1), jnp.float64)[None, :])
        f_k = mbar_free_energies(u_kn, jnp.full((r,), m), num_iters=500)
        log_w = np.asarray(mbar_log_weights(u_kn, jnp.full((r,), m),
                                            f_k, 0))
    lw = log_w - log_w.max()
    wgt = np.exp(lw)
    wgt /= wgt.sum()
    na_pool = na_t.transpose(1, 0, 2).reshape(-1)
    nb_pool = nb_t.transpose(1, 0, 2).reshape(-1)
    df_mbar = float(np.log(max((wgt * nb_pool).sum(), 1e-300)
                           / max((wgt * na_pool).sum(), 1e-300)))
    df_sector_mbar = float(np.log(
        max((wgt * all_b_t.transpose(1, 0, 2).reshape(-1)).sum(), 1e-300)
        / max((wgt * all_a_t.transpose(1, 0, 2).reshape(-1)).sum(),
              1e-300)))
    # block SEM over 5 round-blocks (shared f_k)
    blocks = []
    idx = np.arange(r * m).reshape(r, -1, w)
    t_post = idx.shape[1]
    for b in range(5):
        sel = np.zeros(r * m, bool)
        sel[idx[:, b * t_post // 5:(b + 1) * t_post // 5].reshape(-1)] = True
        wb = np.where(sel, wgt, 0.0)
        blocks.append(float(np.log(max((wb * nb_pool).sum(), 1e-300)
                                   / max((wb * na_pool).sum(), 1e-300))))
    df_mbar_sem = float(np.std(blocks) / np.sqrt(len(blocks)))
    logger.info("MBAR delta F = %.4f +- %.4f (pooled %d samples; "
                "cold-only %.4f); sector dF cold=%.4f mbar=%.4f",
                df_mbar, df_mbar_sem, r * m, df_cold, df_sector_cold,
                df_sector_mbar)
    metrics.log("free_energy", occupancy_mean=final_mean,
                occupancy_sem=final_sem, df_particle_cold=df_cold,
                df_particle_mbar=df_mbar, df_particle_mbar_sem=df_mbar_sem,
                df_sector_cold=df_sector_cold,
                df_sector_mbar=df_sector_mbar)

    cls = classify_particles(cold_pos[burn:].reshape(-1, n, 2),
                             config.half_box, config.r0)
    plot_state_histogram(cls, directory)

    write_evidence(config, {
        "driver": "tempering",
        "sampler": "pt",
        "ladder": {"replicas": r, "t_hot": config.pt_t_hot,
                   "kind": config.pt_ladder,
                   "betas": [round(float(b), 5) for b in
                             np.asarray(betas)]},
        "rounds": t_rounds, "moves_per_round": mpr, "walkers": w,
        "edge_acceptance": [round(float(a), 4) for a in edge_acc],
        "delta_f_mean": final_mean, "delta_f_sem": final_sem,
        "delta_f_std": final_std,
        "df_particle_cold": round(df_cold, 4),
        "df_particle_mbar": round(df_mbar, 4),
        "df_particle_mbar_sem": round(df_mbar_sem, 4),
        "df_sector_cold": round(df_sector_cold, 4),
        "df_sector_mbar": round(df_sector_mbar, 4),
        "mbar_f_k": [round(float(x), 3) for x in np.asarray(f_k)],
        "sector_counts": sector_counts(cold_pos[burn:], config.half_box,
                                       config.r0),
    })
    return {"delta_f_mean": final_mean, "delta_f_sem": final_sem,
            "df_particle_cold": df_cold, "df_particle_mbar": df_mbar,
            "df_particle_mbar_sem": df_mbar_sem,
            "df_sector_cold": df_sector_cold,
            "df_sector_mbar": df_sector_mbar,
            "edge_acceptance": edge_acc.tolist(), "directory": directory,
            "rounds": t_rounds}


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Parallel-tempering production experiment")
    parser.add_argument("--experiment_id", type=str, required=True)
    parser.add_argument("--num_chains", type=int, default=50,
                        help="walkers per replica")
    parser.add_argument("--num_particles", type=int, default=3)
    parser.add_argument("--total_steps", type=int, default=10_000_000,
                        help="cold-replica local-move budget (split over "
                             "walkers, as the baseline driver)")
    parser.add_argument("--replicas", type=int, default=10)
    parser.add_argument("--t_hot", type=float, default=10.0)
    parser.add_argument("--moves_per_round", type=int, default=150)
    parser.add_argument("--ladder", choices=("geometric", "linear"),
                        default="geometric")
    parser.add_argument("--segment_rounds", type=int, default=200)
    parser.add_argument("--equilibration_steps", type=int, default=None,
                        help="default: 5000, or 20000 for N > 12 "
                             "(half-lattice starts need more)")
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument("--resume", action="store_true")
    args = parser.parse_args()
    equil = args.equilibration_steps
    if equil is None:
        equil = 20000 if args.num_particles > 12 else 5000
    config = tempering_config(
        experiment_id=args.experiment_id, num_chains=args.num_chains,
        num_particles=args.num_particles, output_dir=args.output_dir,
        pt_replicas=args.replicas, pt_t_hot=args.t_hot,
        pt_moves_per_round=args.moves_per_round, pt_ladder=args.ladder,
        pt_segment_rounds=args.segment_rounds,
        equilibration_steps=equil)
    out = run(config, total_production_steps=args.total_steps,
              resume=args.resume)
    print({k: v for k, v in out.items() if k != "edge_acceptance"})


if __name__ == "__main__":
    main()
