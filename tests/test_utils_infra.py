"""Tests for the infra utilities: profiling hooks, loggers, metrics, params
snapshots (the aux-subsystem layer of SURVEY.md §5)."""

import importlib.util
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_timer_and_annotate():
    from flowstate.utils.profiling import PhaseTimer, annotate

    timer = PhaseTimer()
    x = jnp.arange(8.0)
    with timer.phase("square", sync_on=x):
        y = x * x
    with timer.phase("square"):
        _ = x + 1
    with annotate("region"):
        _ = jax.device_get(y)
    s = timer.summary()
    assert s["square"]["count"] == 2
    assert s["square"]["total_s"] >= s["square"]["mean_s"] > 0


def test_trace_writes_profile(tmp_path):
    from flowstate.utils.profiling import trace

    log_dir = str(tmp_path / "prof")
    with trace(log_dir):
        _ = jax.device_get(jnp.arange(64.0).sum())
    found = []
    for root, _, files in os.walk(log_dir):
        found += files
    assert found, "profiler trace wrote no files"


def test_setup_logger_and_metrics(tmp_path):
    from flowstate.utils.logging import (
        MetricsWriter, save_params_json, setup_logger,
    )

    log_file = str(tmp_path / "run.log")
    logger = setup_logger("t_infra", log_file)
    logger.info("hello")
    logger.debug("debug-line")
    for h in logger.handlers:
        h.flush()
    content = open(log_file).read()
    assert "hello" in content and "debug-line" in content  # file at DEBUG

    m = MetricsWriter(str(tmp_path / "metrics.jsonl"))
    m.log("cycle", cycle=1, loss=float(np.float32(0.5)),
          arr=jnp.arange(2))
    m.close()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert rows[0]["event"] == "cycle" and rows[0]["cycle"] == 1
    assert rows[0]["arr"] == [0, 1]

    p = save_params_json({"a": 1, "b": jnp.float32(2.5)}, str(tmp_path))
    snap = json.load(open(p))
    assert snap["a"] == 1 and abs(snap["b"] - 2.5) < 1e-6

    # per-run loggers don't duplicate handlers on re-setup
    logger2 = setup_logger("t_infra", log_file)
    assert logger2 is logging.getLogger("t_infra")
    assert len(logger2.handlers) <= 3


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compilation_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins; without it the cache sits at a fixed
    directory inside the checkout."""
    from flowstate.utils import profiling

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expected = os.path.join(REPO, ".jax_cache")
    else:
        expected = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expected)
    assert profiling.compilation_cache_dir() == expected

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert profiling.enable_compilation_cache() == expected
        # with the variable set, the code sets no directory of its own
        assert jax.config.jax_compilation_cache_dir == (
            expected if env_dir is None else None)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu_and_prints_contract_line(tmp_path):
    """On a machine without a GPU chip_smoke.py exits non-zero and prints
    no result; a passing run's last line has the contract's exact form."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    assert chip_smoke.result_line([Dev()]) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def test_drivers_import_without_matplotlib_or_orbax():
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "sys.modules['orbax'] = None\n"
            "import flowstate.experiments.algorithm1, "
            "flowstate.experiments.algorithm2, "
            "flowstate.experiments.mcmc_only, "
            "flowstate.experiments.tempering, "
            "flowstate.experiments.single_run, "
            "flowstate.experiments.train_npz\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_driver_without_matplotlib_writes_plot_data(monkeypatch, tmp_path):
    """With matplotlib missing a driver still writes every plot's JSON data
    and skips only the image files."""
    from flowstate.analysis import plots
    from flowstate.experiments import mcmc_only
    from flowstate.utils.config import mcmc_only_config

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    monkeypatch.setattr(plots, "_PYPLOT", None)
    config = mcmc_only_config(
        experiment_id="no_mpl", output_dir=str(tmp_path), num_chains=2,
        equilibration_steps=200, adjusting_frequency=100,
        sampling_frequency=10)
    d = mcmc_only.run(config, total_production_steps=1000)["directory"]
    assert os.path.exists(os.path.join(d, "avg_free_energy_data.json"))
    assert os.path.exists(os.path.join(d, "state_histogram_data.json"))
    assert not os.path.exists(os.path.join(d, "avg_free_energy.png"))
    assert plots._PYPLOT is None


def test_npz_checkpoint_round_trip(tmp_path):
    from flowstate.mcmc import init_alternating_wells, init_chain_state
    from flowstate.ops import Box, SystemSpec
    from flowstate.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint,
    )

    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2)
    pos, _ = init_alternating_wells(4, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(3))
    tree = {"flow": [{"w": jnp.ones((2, 3)), "b": jnp.arange(3)}],
            "chains": state._asdict()}
    save_checkpoint(str(tmp_path), 3, tree, metadata={"cycle": 3})
    save_checkpoint(str(tmp_path), 7, jax.device_get(tree))
    step, path = latest_checkpoint(str(tmp_path))
    assert step == 7
    back, meta = restore_checkpoint(path, tree)
    assert meta is None
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        if jax.dtypes.issubdtype(b.dtype, jax.dtypes.prng_key):
            a, b = jax.random.key_data(a), jax.random.key_data(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # restored keys draw the same numbers as the originals
    np.testing.assert_array_equal(
        jax.random.uniform(back["chains"]["key"][1]),
        jax.random.uniform(state.key[1]))
    _, meta3 = restore_checkpoint(os.path.join(
        str(tmp_path), "step_00000003"), tree)
    assert meta3 == {"cycle": 3}
    assert os.listdir(path) == ["tree.npz"]
