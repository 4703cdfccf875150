"""End-to-end smoke tests: the three drivers at demo scale.

These are the framework's integration tests (the reference's only
integration story is its demo notebooks, SURVEY.md §4); tiny budgets keep
them CPU-fast while exercising every phase.
"""

import os

import numpy as np
import pytest

from flowstate.utils.config import (
    algorithm1_config, algorithm2_config, mcmc_only_config,
)


def test_mcmc_only_smoke(tmp_path):
    from flowstate.experiments import mcmc_only
    config = mcmc_only_config(
        experiment_id="smoke", output_dir=str(tmp_path), num_chains=4,
        equilibration_steps=300, adjusting_frequency=100,
        sampling_frequency=10)
    results = mcmc_only.run(config, total_production_steps=8000)
    assert results["samples_per_chain"] == 200
    d = results["directory"]
    assert os.path.exists(os.path.join(d, "params.json"))
    assert os.path.exists(os.path.join(d, "avg_free_energy.png"))
    assert os.path.exists(os.path.join(d, "mc_runs", "run_001",
                                       "sampled_data.csv"))
    assert os.path.exists(os.path.join(d, "mc_runs", "run_001",
                                       "mc_run_configs.npy"))
    configs = np.load(os.path.join(d, "mc_runs", "run_001",
                                   "mc_run_configs.npy"))
    assert configs.shape == (200, 3, 2)
    assert np.all(configs >= 0) and np.all(configs <= 10.0)
    # committed-evidence summary (VERDICT r2 item 7)
    import json
    ev = json.load(open(os.path.join(str(tmp_path), "evidence",
                                     "smoke_data.json")))
    assert ev["driver"] == "mcmc_only"
    assert "sector_counts" in ev and "delta_f_mean" in ev


@pytest.mark.parametrize("sampler", ["mala", "hmc"])
def test_mcmc_only_sampler_variants(tmp_path, sampler):
    """--sampler mala/hmc runs the same driver with the gradient kernels
    (beyond-reference; budget convention of SAMPLERS.md)."""
    from flowstate.experiments import mcmc_only
    config = mcmc_only_config(
        experiment_id=f"smoke_{sampler}", output_dir=str(tmp_path),
        num_chains=2, equilibration_steps=200, adjusting_frequency=100,
        sampling_frequency=10, sampler=sampler, num_leapfrog=5)
    results = mcmc_only.run(config, total_production_steps=2000)
    assert results["samples_per_chain"] == 100
    d = results["directory"]
    configs = np.load(os.path.join(d, "mc_runs", "run_001",
                                   "mc_run_configs.npy"))
    assert configs.shape == (100, 3, 2)
    assert np.all(configs >= 0) and np.all(configs <= 10.0)
    assert np.all(np.isfinite(configs))
    import json
    ev = json.load(open(os.path.join(str(tmp_path), "evidence",
                                     f"smoke_{sampler}_data.json")))
    assert ev["sampler"] == sampler
    # statistical gate: post-re-adaptation production acceptance must land
    # in a band around the sampler's adaptation target (MALA 0.574, HMC
    # 0.65) — a run pinned at 0 or 1 means the eps re-adaptation after the
    # Metropolis->gradient-kernel swap failed (VERDICT r3 item 7)
    target = {"mala": 0.574, "hmc": 0.65}[sampler]
    assert ev["production_acceptance"] == results["production_acceptance"]
    assert abs(results["production_acceptance"] - target) < 0.25, (
        f"{sampler} production acceptance "
        f"{results['production_acceptance']:.3f} outside target band")


def test_mcmc_only_unknown_sampler(tmp_path):
    from flowstate.experiments import mcmc_only
    config = mcmc_only_config(
        experiment_id="bad_sampler", output_dir=str(tmp_path), num_chains=2,
        equilibration_steps=100, adjusting_frequency=50,
        sampling_frequency=10, sampler="nuts")
    with pytest.raises(ValueError, match="unknown sampler"):
        mcmc_only.run(config, total_production_steps=200)


def test_algorithm1_smoke(tmp_path):
    from flowstate.experiments import algorithm1
    config = algorithm1_config(
        experiment_id="smoke_a1", output_dir=str(tmp_path), num_chains=4,
        equilibration_steps=200, adjusting_frequency=100,
        sampling_frequency=10, initial_training_num_samples=64,
        batch_size=16, epochs=2, K=2, hidden_units=16, num_bins=4,
        big_move_attempts=3, big_move_interval=20,
        num_samples_for_analysis=100)
    results = algorithm1.run(config)
    d = results["directory"]
    assert np.isfinite(results["final_loss"])
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert os.path.exists(os.path.join(d, "nf_acceptance_rate.png"))
    assert os.path.exists(os.path.join(d, "acceptance_rate_data.csv"))
    assert os.path.exists(os.path.join(
        d, "training_rounds", "initial_training_round",
        "initial_model_circularspline_res_dense.pkl"))
    assert "delta_f_mean" in results


def test_algorithm1_fused_testing_matches_host_loop(tmp_path):
    """The fused on-device testing scan consumes the PRNG streams in the
    same order as the host-driven loop, so for fixed seeds the two paths
    must produce the same acceptance history and free energy."""
    from flowstate.experiments import algorithm1

    def go(fused, eid):
        config = algorithm1_config(
            experiment_id=eid, output_dir=str(tmp_path), num_chains=4,
            equilibration_steps=200, adjusting_frequency=100,
            sampling_frequency=10, initial_training_num_samples=64,
            batch_size=16, epochs=2, K=2, hidden_units=16, num_bins=4,
            big_move_attempts=4, big_move_interval=20,
            num_samples_for_analysis=50, fused_testing=fused)
        return algorithm1.run(config)

    r_fused = go(True, "a1_fused")
    r_loop = go(False, "a1_loop")
    assert r_fused["big_move_acceptance"] == r_loop["big_move_acceptance"]
    a_fused = np.loadtxt(os.path.join(r_fused["directory"],
                                      "acceptance_rate_data.csv"),
                         delimiter=",", skiprows=1)
    a_loop = np.loadtxt(os.path.join(r_loop["directory"],
                                     "acceptance_rate_data.csv"),
                        delimiter=",", skiprows=1)
    np.testing.assert_allclose(a_fused, a_loop, rtol=0, atol=0)
    if np.isfinite(r_loop["delta_f_mean"]):
        np.testing.assert_allclose(r_fused["delta_f_mean"],
                                   r_loop["delta_f_mean"], rtol=1e-6)


def test_algorithm2_smoke(tmp_path):
    from flowstate.experiments import algorithm2
    config = algorithm2_config(
        experiment_id="smoke_a2", output_dir=str(tmp_path), num_chains=4,
        equilibration_steps=200, adjusting_frequency=100,
        sampling_frequency=5, initial_training_num_samples=16,
        update_num_samples=16, batch_size=8, epochs=1, K=2,
        hidden_units=16, num_bins=4, num_training_cycles=4,
        checkpoint_interval=2, num_samples_for_analysis=64,
        num_samples_for_free_energy=8)
    results = algorithm2.run(config)
    d = results["directory"]
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert "delta_f_mean" in results
    assert os.path.exists(os.path.join(d, "p_acc_vs_training_samples.png"))
    # checkpoint written at cycle 4 (= 2 * checkpoint_interval)
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000004"))
    import json
    ev = json.load(open(os.path.join(str(tmp_path), "evidence",
                                     "smoke_a2_data.json")))
    assert ev["driver"] == "algorithm2"
    for key in ("p_acc_history", "loss_per_cycle", "sector_counts",
                "delta_f_mean"):
        assert key in ev


def test_algorithm2_fused_smoke(tmp_path):
    """The fused on-device cycle path (training/cycles.py) produces the
    same artifact set and sane statistics as the per-cycle host loop."""
    from flowstate.experiments import algorithm2
    config = algorithm2_config(
        experiment_id="smoke_a2_fused", output_dir=str(tmp_path),
        num_chains=4, equilibration_steps=200, adjusting_frequency=100,
        sampling_frequency=5, initial_training_num_samples=16,
        update_num_samples=16, batch_size=8, epochs=1, K=2,
        hidden_units=16, num_bins=4, num_training_cycles=5,
        checkpoint_interval=2, num_samples_for_analysis=64,
        num_samples_for_free_energy=8)
    results = algorithm2.run(config, fused=True)
    d = results["directory"]
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert "delta_f_mean" in results
    import numpy as np
    assert np.isfinite(results["delta_f_mean"])
    # chunked checkpoints: chunk = 2*interval = 4, remainder chunk -> 5
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000004"))
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000005"))
    assert os.path.exists(os.path.join(d, "p_acc_vs_training_samples.png"))


def test_algorithm2_freeze_after(tmp_path):
    """Finite-adaptation mode: flow params must stop changing after the
    freeze cycle (fused path), while big moves keep being attempted."""
    import jax
    import jax.numpy as jnp

    from flowstate.experiments.algorithm2 import run as run_a2
    from flowstate.flows import build_circular_flow
    from flowstate.mcmc import init_alternating_wells, init_chain_state
    from flowstate.ops import Box, SystemSpec
    from flowstate.training.cycles import make_fused_cycles
    from flowstate.utils.config import algorithm2_config

    # unit level: a frozen fused chunk returns params unchanged (bitwise)
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0),
                             num_wells=2, V0_list=(-10.0, -10.5),
                             r0=1.2, k=15.0)
    model = build_circular_flow(3, 2, 5.0, K=2, hidden_units=8, num_bins=4)
    params = model.init_params(jax.random.key(0))
    cfg = algorithm2_config(num_chains=4, update_num_samples=16,
                            batch_size=8, epochs=1, sampling_frequency=5)
    pos, _ = init_alternating_wells(4, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(1), 0.5)
    frozen = make_fused_cycles(model, spec, cfg, 2, train=False)
    p2, state2, _, out = frozen(params, state, jax.random.key(2))
    assert all(bool(jnp.all(a == b)) for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(p2)))
    assert bool(jnp.all(jnp.isnan(out["loss"])))
    # production still advanced the chains
    assert not bool(jnp.all(state.positions == state2.positions))

    # driver level: --freeze_after runs end to end (fused)
    config = algorithm2_config(
        experiment_id="smoke_a2_freeze", output_dir=str(tmp_path),
        num_chains=4, equilibration_steps=200, adjusting_frequency=100,
        sampling_frequency=5, initial_training_num_samples=16,
        update_num_samples=16, batch_size=8, epochs=1, K=2,
        hidden_units=16, num_bins=4, num_training_cycles=6,
        checkpoint_interval=2, num_samples_for_analysis=64,
        num_samples_for_free_energy=8)
    results = run_a2(config, fused=True, freeze_after=2)
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert np.isfinite(results["delta_f_mean"])


def test_fused_cycles_requires_static_regime():
    import pytest

    from flowstate.flows import build_circular_flow
    from flowstate.ops import Box, SystemSpec
    from flowstate.training.cycles import make_fused_cycles
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0))
    model = build_circular_flow(3, 2, 5.0, K=2, hidden_units=8, num_bins=4)
    cfg = algorithm2_config(cumulative_training_samples=True)
    with pytest.raises(ValueError, match="non-cumulative"):
        make_fused_cycles(model, spec, cfg, 2)
    cfg = algorithm2_config(alpha=0.5)
    with pytest.raises(ValueError, match="alpha"):
        make_fused_cycles(model, spec, cfg, 2)


def test_algorithm2_resume(tmp_path):
    """Checkpoint-resume continues the cycle loop from the stored state."""
    from flowstate.experiments import algorithm2
    config = algorithm2_config(
        experiment_id="resume_a2", output_dir=str(tmp_path), num_chains=4,
        equilibration_steps=100, adjusting_frequency=100,
        sampling_frequency=5, initial_training_num_samples=16,
        update_num_samples=16, batch_size=8, epochs=1, K=2,
        hidden_units=16, num_bins=4, num_training_cycles=4,
        checkpoint_interval=2, num_samples_for_analysis=64,
        num_samples_for_free_energy=8)
    algorithm2.run(config)
    ckpt_dir = os.path.join(str(tmp_path), "resume_a2", "checkpoints")
    assert os.path.exists(os.path.join(ckpt_dir, "step_00000004"))
    # resume with a larger cycle budget: continues from cycle 4
    config2 = algorithm2_config(
        experiment_id="resume_a2", output_dir=str(tmp_path), num_chains=4,
        equilibration_steps=100, adjusting_frequency=100,
        sampling_frequency=5, initial_training_num_samples=16,
        update_num_samples=16, batch_size=8, epochs=1, K=2,
        hidden_units=16, num_bins=4, num_training_cycles=6,
        checkpoint_interval=2, num_samples_for_analysis=64,
        num_samples_for_free_energy=8)
    results = algorithm2.run(config2, resume=True)
    assert "big_move_acceptance" in results


def test_tempering_driver_smoke_and_resume(tmp_path):
    """PT production driver: segments, observables, MBAR ΔF, resume."""
    import json

    from flowstate.experiments import tempering
    from flowstate.utils.config import tempering_config

    config = tempering_config(
        experiment_id="pt_smoke", output_dir=str(tmp_path), num_chains=8,
        num_particles=3, pt_replicas=4, pt_moves_per_round=20,
        pt_segment_rounds=5, equilibration_steps=300,
        adjusting_frequency=100)
    results = tempering.run(config, total_production_steps=8 * 20 * 15)
    assert results["rounds"] == 15
    assert np.isfinite(results["df_particle_mbar"])
    assert len(results["edge_acceptance"]) == 3
    d = results["directory"]
    assert os.path.exists(os.path.join(d, "segments", "seg_0002.npz"))
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000003"))
    assert os.path.exists(os.path.join(d, "avg_free_energy.png"))
    ev = json.load(open(os.path.join(str(tmp_path), "evidence",
                                     "pt_smoke_data.json")))
    assert ev["sampler"] == "pt"
    assert len(ev["ladder"]["betas"]) == 4

    # resume with a larger budget: runs only the missing segments
    results2 = tempering.run(config, total_production_steps=8 * 20 * 25,
                             resume=True)
    assert results2["rounds"] == 25
    assert os.path.exists(os.path.join(d, "checkpoints", "step_00000005"))


def test_algorithm1_blocked_smoke(tmp_path):
    """A1 with blocked conditional proposals (blocked_k > 0): Phase C
    trains the conditional flow, Phase D runs block sweeps."""
    from flowstate.experiments import algorithm1

    config = algorithm1_config(
        experiment_id="a1_blocked", output_dir=str(tmp_path), num_chains=8,
        num_particles=4, blocked_k=2, equilibration_steps=1000,
        adjusting_frequency=200, initial_training_num_samples=1024,
        sampling_frequency=10, batch_size=128, epochs=4, K=4,
        hidden_units=32, num_bins=8, big_move_attempts=10,
        big_move_interval=20, num_samples_for_analysis=256)
    results = algorithm1.run(config)
    assert np.isfinite(results["final_loss"])
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    d = results["directory"]
    assert os.path.exists(os.path.join(
        d, "training_rounds", "initial_training_round",
        "initial_model_blocked_conditional.pkl"))
    assert os.path.exists(os.path.join(d, "acceptance_rate_data.csv"))


def test_algorithm2_blocked_smoke(tmp_path):
    """A2 cycle loop with blocked conditional retraining (blocked_k)."""
    from flowstate.experiments import algorithm2

    config = algorithm2_config(
        experiment_id="a2_blocked", output_dir=str(tmp_path), num_chains=8,
        num_particles=4, blocked_k=2, equilibration_steps=300,
        adjusting_frequency=100, sampling_frequency=5,
        initial_training_num_samples=256, update_num_samples=256,
        batch_size=64, epochs=2, K=3, hidden_units=16, num_bins=4,
        num_training_cycles=4, checkpoint_interval=2,
        num_samples_for_analysis=128, num_samples_for_free_energy=32)
    results = algorithm2.run(config)
    assert 0.0 <= results["big_move_acceptance"] <= 1.0
    assert os.path.exists(os.path.join(results["directory"], "checkpoints",
                                       "step_00000004"))
    # gates: blocked needs the host-driven loop and a pure-MLE loss
    with pytest.raises(ValueError, match="host-driven"):
        algorithm2.run(config, fused=True)
    with pytest.raises(ValueError, match="alpha=1.0"):
        algorithm2.run(algorithm2_config(
            experiment_id="bad", output_dir=str(tmp_path), blocked_k=2,
            alpha=0.5))


def test_tempering_driver_validates_sampler(tmp_path):
    from flowstate.experiments import tempering
    from flowstate.utils.config import tempering_config

    config = tempering_config(experiment_id="bad", output_dir=str(tmp_path),
                              sampler="metropolis")
    with pytest.raises(ValueError, match="sampler='pt'"):
        tempering.run(config)


def test_algorithm1_premade_data(tmp_path):
    """A1 variant starting from saved NPZ data (reference's premade-data
    notebook, SURVEY.md §2.3)."""
    from flowstate.experiments import algorithm1
    rng = np.random.default_rng(0)
    npz_path = str(tmp_path / "premade.npz")
    np.savez(npz_path,
             configs=rng.uniform(-5, 5, (256, 3, 2)).astype(np.float32))
    config = algorithm1_config(
        experiment_id="premade_a1", output_dir=str(tmp_path), num_chains=4,
        equilibration_steps=100, adjusting_frequency=100,
        sampling_frequency=10, batch_size=32, epochs=1, K=2,
        hidden_units=16, num_bins=4, big_move_attempts=2,
        big_move_interval=20, num_samples_for_analysis=50)
    results = algorithm1.run(config, premade_data_path=npz_path)
    assert np.isfinite(results["final_loss"])
