"""Shared experiment plumbing: setup, equilibration, artifact dumps.

Factored from the common preamble of the three reference drivers
(``main_mcmc_only.py``, ``main_algorithm_1.py``, ``main_algorithm_2.py``):
directory layout, params.json provenance, per-run loggers, alternating-well
chain init, equilibration, and the CSV/NPY artifact dumps
(main_algorithm_1.py:499-548).
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis.plots import plot_potential
from flowstate.mcmc import (
    ChainState, init_alternating_wells, init_chain_state,
    run_equilibration_batch,
)
from flowstate.ops import Box, SystemSpec
from flowstate.utils.config import ExperimentConfig
from flowstate.utils.logging import MetricsWriter, setup_logger


def build_system(config: ExperimentConfig) -> SystemSpec:
    box = Box.from_density(config.num_particles, config.rho,
                           config.aspect_ratio)
    return SystemSpec.create(
        config.num_particles, box, num_wells=config.num_wells,
        V0_list=config.V0_list, r0=config.r0, k=config.k_val)


def setup_experiment(config: ExperimentConfig
                     ) -> Tuple[str, logging.Logger, MetricsWriter]:
    """Create the experiment directory tree + logger + metrics stream.

    Mirrors main_algorithm_1.py:80-134 (directory, experiment.log,
    params.json) with an added metrics.jsonl.  Also enables the persistent
    compilation cache so repeated runs skip device recompiles.
    """
    from flowstate.utils.profiling import enable_compilation_cache
    try:
        enable_compilation_cache()
    except Exception:
        pass
    directory = os.path.join(config.output_dir, config.experiment_id)
    os.makedirs(directory, exist_ok=True)
    os.makedirs(os.path.join(directory, "mc_runs"), exist_ok=True)
    os.makedirs(os.path.join(directory, "training_rounds"), exist_ok=True)
    logger = setup_logger("experiment",
                          os.path.join(directory, "experiment.log"),
                          stream_level=logging.INFO)
    config.save(os.path.join(directory, "params.json"))
    metrics = MetricsWriter(os.path.join(directory, "metrics.jsonl"))
    logger.info("half box is: %s", config.half_box)
    logger.info("Directory created at: %s", directory)
    return directory, logger, metrics


def init_and_equilibrate(config: ExperimentConfig, spec: SystemSpec,
                         logger: Optional[logging.Logger] = None
                         ) -> ChainState:
    """Alternating-well init + adaptive equilibration, fully jitted.

    Reference: per-run init loop main_algorithm_1.py:136-199 +
    equilibration main_algorithm_1.py:203-210.
    """
    positions, _ = init_alternating_wells(
        config.num_chains, config.num_particles, config.rho,
        config.aspect_ratio)
    state = init_chain_state(spec, jnp.asarray(positions),
                             jax.random.key(config.master_seed),
                             config.initial_max_displacement)
    if logger:
        logger.info("All %d chains initialised (alternating wells)",
                    config.num_chains)
    state = run_equilibration_batch(
        spec, config.beta, state, config.equilibration_steps,
        config.adjusting_frequency, config.target_acceptance)
    if logger:
        logger.info("Equilibration done: %d steps/chain",
                    config.equilibration_steps)
    return state


def plot_wells(config: ExperimentConfig, spec: SystemSpec,
               directory: str) -> None:
    plot_potential(spec.box.size_x, spec.box.size_y, list(config.V0_list),
                   config.r0, config.k_val, config.num_wells, directory)


def _thin(seq, max_points: int = 2000) -> list:
    """Subsample a long series to <= max_points (keeps first/last)."""
    arr = np.asarray(seq, dtype=float)
    if arr.size <= max_points:
        return arr.tolist()
    idx = np.unique(np.round(
        np.linspace(0, arr.size - 1, max_points)).astype(int))
    return arr[idx].tolist()


def write_evidence(config: ExperimentConfig, payload: dict,
                   evidence_dir: Optional[str] = None) -> str:
    """Commit-sized per-run summary JSON.

    Every headline experiment emits its key numbers (ΔF statistics,
    acceptance/loss curves, sector counts) into ``results/evidence/`` —
    the one ``results/`` subtree .gitignore keeps — so claims in
    RESULTS.md/SECTORS.md are traceable to committed artifacts without
    re-running multi-hour jobs.  Mirrors the reference's
    every-plot-saves-its-JSON convention (``hybrid_NF_MCMC/utils.py:402-406``)
    at the whole-run level.
    """
    import datetime
    import json

    if evidence_dir is None:
        evidence_dir = os.path.join(config.output_dir, "evidence")
    os.makedirs(evidence_dir, exist_ok=True)
    doc = {
        "experiment_id": config.experiment_id,
        "written_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "device": str(jax.devices()[0]),
        "config": config.to_dict(),
        **payload,
    }
    path = os.path.join(evidence_dir, f"{config.experiment_id}_data.json")

    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=default)
    return path


def sector_counts(configs: np.ndarray, half_box: float, r0: float = 1.2,
                  burn_frac: float = 0.5) -> dict:
    """Sector occupancy summary of a (C, T, N, 2) trajectory stack.

    The same classification tools/sector_check.py applies (0..N = number of
    particles in well B for fully-in-well configs; 'outside' = any particle
    in neither well), counted after discarding the first ``burn_frac`` of
    every chain — compact enough to commit as evidence.
    """
    from flowstate.analysis import classify_particles

    t = configs.shape[1]
    post = configs[:, int(t * burn_frac):]
    lab = classify_particles(post, half_box, r0)          # (C, T', N)
    n_b = (lab == 1).sum(axis=-1)
    any_out = (lab == 2).any(axis=-1)
    n = configs.shape[2]
    sec = np.where(any_out, n + 1, n_b)
    counts = {f"{k}B": int((sec == k).sum()) for k in range(n + 1)}
    counts["outside"] = int((sec == n + 1).sum())
    counts["burn_frac"] = burn_frac
    return counts


def dump_run_artifacts(directory: str, run_idx: int,
                       observables, testing_configs: Optional[np.ndarray]
                       ) -> None:
    """Per-run sampled_data.csv + configs NPY; main_algorithm_1.py:499-548."""
    run_dir = os.path.join(directory, "mc_runs", f"run_{run_idx + 1:03d}")
    os.makedirs(run_dir, exist_ok=True)

    csv_path = os.path.join(run_dir, "sampled_data.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["cycle_number", "energy_per_particle", "density",
                         "pressure", "box_size_x", "box_size_y",
                         "particle_configuration"])
        t = len(observables.cycle)
        for i in range(t):
            writer.writerow([
                int(observables.cycle[i]),
                float(observables.energy_per_particle[i]),
                float(observables.density[i]),
                float(observables.pressure[i]),
                float(observables.box_size_x[i]),
                float(observables.box_size_y[i]),
                np.asarray(observables.positions[i]).flatten().tolist(),
            ])

    np.save(os.path.join(run_dir, "mc_run_configs.npy"),
            np.asarray(observables.positions))
    if testing_configs is not None:
        np.save(os.path.join(run_dir, "mc_run_testing_configs.npy"),
                np.asarray(testing_configs))
