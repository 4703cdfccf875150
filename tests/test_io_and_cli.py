"""Tests: single-run CLI, sweep runner, native flock aggregator, NPZ trainer."""

import os
import subprocess
import sys

import numpy as np
import pytest

from flowstate.io.aggregate import (
    _load_native, append_results, append_row_locked,
)


def test_native_aggregator_compiles_and_appends(tmp_path):
    lib = _load_native()
    assert lib is not None, "g++ available in this image; native must build"
    path = str(tmp_path / "results.csv")
    append_row_locked(path, "1.0,0.03,0.1,1.0", header="t,rho,p,ar")
    append_row_locked(path, "2.0,0.04,0.2,1.0", header="t,rho,p,ar")
    lines = open(path).read().strip().split("\n")
    assert lines == ["t,rho,p,ar", "1.0,0.03,0.1,1.0", "2.0,0.04,0.2,1.0"]


def test_aggregator_concurrent_processes(tmp_path):
    """Many processes appending concurrently must not interleave rows."""
    path = str(tmp_path / "shared.csv")
    script = (
        "import sys; sys.path.insert(0, %r); "
        "from flowstate.io.aggregate import append_row_locked; "
        "[append_row_locked(%r, f'{%d},{i}', header='proc,i') "
        "for i in range(50)]")
    procs = [
        subprocess.Popen([sys.executable, "-c",
                          script % ("/root/repo", path, p)])
        for p in range(4)
    ]
    for p in procs:
        assert p.wait() == 0
    lines = open(path).read().strip().split("\n")
    assert lines[0] == "proc,i"
    assert len(lines) == 1 + 4 * 50
    # every line is well-formed (no torn writes)
    for line in lines[1:]:
        a, b = line.split(",")
        assert 0 <= int(a) < 4 and 0 <= int(b) < 50


def test_single_run_cli(tmp_path):
    from flowstate.experiments import single_run
    summary = single_run.main([
        "--temperature", "1.0", "--num_particles", "3",
        "--initial_rho", "0.03", "--equilibration_steps", "300",
        "--production_steps", "600", "--sampling_frequency", "50",
        "--adjusting_frequency", "100", "--output_path", str(tmp_path),
        "--experiment_id", "cli_test", "--num_wells", "2",
        "--V0_list", "-10.0", "-10.5", "--k", "15", "--r0", "1.2",
        "--initialisation_type", "low_left", "--seed", "7",
        "--initial_max_displacement", "0.65", "--num_chains", "4",
        "--visualise",
    ])
    assert 0.1 < summary["acceptance_fraction"] < 0.99
    out = os.path.join(str(tmp_path), "cli_test")
    npz = np.load(os.path.join(out, "production_configs.npz"))
    assert npz["configs"].shape == (4, 12, 3, 2)
    assert np.all(np.abs(npz["configs"]) <= 5.0 + 1e-5)  # centered frame
    assert os.path.exists(os.path.join(out, "sampled_data.csv"))
    assert os.path.exists(os.path.join(out, "simulation_snapshots.png"))


def test_sweep_runner(tmp_path):
    from flowstate.experiments.sweep import SweepParams, run_experiments
    params = SweepParams(
        output_path=str(tmp_path), experiment_id="sw",
        density_start=0.03, density_end=0.04, density_intervals=2,
        equilibration_steps=100, production_steps=300,
        sampling_frequency=50, adjusting_frequency=100, num_chains=2,
        initialisation_type="low_left")
    results_csv = run_experiments(params)
    lines = open(results_csv).read().strip().split("\n")
    assert len(lines) == 3  # header + 2 grid points
    assert os.path.exists(os.path.join(str(tmp_path), "sw",
                                       "parameters.json"))


def test_npz_trainer(tmp_path):
    from flowstate.experiments import train_npz
    rng = np.random.default_rng(0)
    configs = rng.uniform(-5, 5, size=(300, 3, 2)).astype(np.float32)
    npz_path = str(tmp_path / "data.npz")
    np.savez(npz_path, configs=configs)
    result = train_npz.main([
        "--npz_path", npz_path, "--output_path", str(tmp_path / "out"),
        "--K", "2", "--hidden_units", "16", "--num_bins", "4",
        "--half_box", "5.0", "--batch_size", "64", "--epochs", "2",
        "--eval_samples", "500",
    ])
    assert np.isfinite(result["final_loss"])
    assert os.path.exists(str(tmp_path / "out" / "trained_model.pkl"))
    assert os.path.exists(str(tmp_path / "out" / "frequency_heatmap.png"))


def test_ess_check_tool_smoke(tmp_path):
    """tools/ess_check.py at tiny scale: runs all three phases (plain,
    train, hybrid), writes the report, returns well-formed metrics."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ess_check", os.path.join(os.path.dirname(__file__), "..",
                                  "tools", "ess_check.py"))
    ess_check = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ess_check)
    out = str(tmp_path / "ESS.md")
    result = ess_check.main(["--chains", "4", "--rounds", "24",
                             "--moves_per_round", "5", "--epochs", "1",
                             "--exact_samples", "20000",
                             "--exact_seeds", "2",
                             "--out", out])
    assert result["metric"] == "well_state_ess_per_s"
    # the headline is None when the dF self-consistency gate fails (it
    # will at this tiny budget); the raw ESS must still be recorded
    assert result["value"] is None or result["value"] >= 0.0
    assert result["hybrid_ess"] >= 0.0
    assert 0.0 <= result["hybrid_acceptance"] <= 1.0
    assert os.path.exists(out)
