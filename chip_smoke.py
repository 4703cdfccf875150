"""Smoke test of the sampler's main path on one GPU, at full flow width.

    python chip_smoke.py               # phases a-e on one GPU
    python chip_smoke.py --four-cards  # phase f only, on four GPUs

Phases (each raises on failure; none is skipped):
  a. Algorithm 1 through ``experiments.algorithm1.run`` (equilibration,
     production, flow training, fused big-move testing).
  b. Three fused Algorithm-2 cycles at the A2 preset width.
  c. One round of blocked conditional moves, N=8, k=1, 16,384 chains.
  d. The Triton Metropolis kernel, compiled for the card, against the plain
     engine (``jax.vmap(metropolis.run_moves)``) at N=3 and 16,384 chains;
     then the tests marked ``gpu``.
  e. Flow numerics at the A1 width: log_prob at default matmul precision
     against "highest" and against the CPU, the sample -> inverse round
     trip, and the self-proposal MH log-ratio.
  f. (``--four-cards``) ``__graft_entry__.dryrun_multichip(4)``: the
     sharded Metropolis segment and the data-parallel training step, each
     compared with the same computation on one device.

Weights are random from fixed seeds; only run lengths are cut (printed as
"cut:" lines).  The card's ``nvidia-smi`` name and power limit are printed
before the last line, which is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Exits non-zero, with no such line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
NUM_CHAINS = 16384

# Phase d: the kernel and the plain engine run the same Markov chain with
# different random streams, so they agree statistically.
ACCEPTANCE_TOL = 0.02
SE_MULTIPLE = 3.0
RESYNC_REL_TOL = 1e-4   # cached energy vs a full recompute, after 4,096
                        # float32 delta updates per chain

# Phase e: log q enters the MH ratio as log q(old) - log q(new), so an error
# delta in it skews every acceptance by exp(delta).  1e-3 keeps that skew
# far below the ~0.05 statistical error of a ΔF run (RESULTS.md), and the
# float32 computation on the CPU and on the card at "highest" precision
# agree to ~1e-5.  The round trip must hold to float32 spline-inversion
# accuracy (~1e-5 in box units) with margin: a larger error means log q of
# a state differs between the step that proposed it and the step that
# judges it as the old state.
LOG_PROB_ABS_TOL = 1e-3
ROUND_TRIP_ABS_TOL = 1e-4


def result_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase(name: str):
    def wrap(fn):
        def run(*args):
            t0 = time.perf_counter()
            print(f"phase {name}: start", flush=True)
            out = fn(*args)
            print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            return out
        return run
    return wrap


@phase("a (Algorithm 1)")
def phase_a(tmp: str) -> None:
    from flowstate.experiments import algorithm1
    from flowstate.utils.config import algorithm1_config

    cuts = dict(epochs=1, big_move_attempts=20, equilibration_steps=1000)
    print("cut: A1 epochs 100 -> 1 (200 steps of 512), big-move attempts "
          "1000 -> 20, equilibration 5000 -> 1000 moves")
    cfg = algorithm1_config(experiment_id="a1", output_dir=tmp, **cuts)
    res = algorithm1.run(cfg)
    print(f"  final_loss={res['final_loss']} "
          f"big_move_acceptance={res['big_move_acceptance']} "
          f"delta_f_mean={res['delta_f_mean']}")
    check(np.isfinite(res["final_loss"]), "A1 loss is not finite")
    check(0.0 < res["big_move_acceptance"] <= 1.0,
          "A1 big-move acceptance outside (0, 1]")
    check(np.isfinite(res["delta_f_mean"]), "A1 delta_f_mean not finite")


@phase("b (A2 fused cycles)")
def phase_b() -> None:
    import jax

    from flowstate.experiments.common import (
        build_system, init_and_equilibrate,
    )
    from flowstate.flows import build_circular_flow
    from flowstate.training.cycles import make_fused_cycles
    from flowstate.utils.config import algorithm2_config

    print("cut: A2 cycles 1000 -> 3, equilibration 5000 -> 1000 moves")
    cfg = algorithm2_config(equilibration_steps=1000)
    spec = build_system(cfg)
    model = build_circular_flow(
        cfg.num_particles, cfg.num_dim, cfg.half_box, K=cfg.K,
        hidden_units=cfg.hidden_units, num_bins=cfg.num_bins,
        num_blocks=cfg.n_blocks)
    params = model.init_params(jax.random.key(cfg.master_seed + 1))
    state = init_and_equilibrate(cfg, spec)
    run = make_fused_cycles(model, spec, cfg, 3)
    params, state, _, out = run(params, state, jax.random.key(5))
    loss = np.asarray(out["loss"])
    print(f"  loss per cycle={loss.ravel().tolist()} "
          f"accepts={np.asarray(out['accepts']).tolist()}")
    check(np.all(np.isfinite(loss)), "A2 loss is not finite")
    check(np.all(np.isfinite(np.asarray(state.positions)))
          and np.all(np.isfinite(np.asarray(state.energy))),
          "A2 chain state is not finite")
    check(all(np.all(np.isfinite(np.asarray(p)))
              for p in jax.tree_util.tree_leaves(params)),
          "A2 flow params are not finite")


@phase("c (blocked moves)")
def phase_c() -> None:
    import jax
    import jax.numpy as jnp

    from flowstate.flows import build_conditional_circular_flow
    from flowstate.mcmc import (
        blocked_big_moves, fourier_context, fourier_context_dim,
        init_chain_state,
    )
    from flowstate.mcmc.initialise import init_split_wells
    from flowstate.ops import Box, SystemSpec

    n = 8
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    hb = float(spec.box.size_x) / 2
    model = build_conditional_circular_flow(
        1, 2, hb, context_features=fourier_context_dim(3), K=6,
        hidden_units=128, num_bins=16)
    params = model.init_params(jax.random.key(21))
    pos, _ = init_split_wells(NUM_CHAINS, n, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(22),
                             0.65)
    res = jax.jit(lambda s: blocked_big_moves(
        spec, 1.0, s, model, params, hb, 1,
        context_fn=lambda r, p: fourier_context(r, p, hb, m_max=3)))(state)
    acc = float(jnp.mean(res.accepted.astype(jnp.float32)))
    print(f"  acceptance={acc}")
    check(0.0 <= acc <= 1.0, "blocked acceptance outside [0, 1]")
    check(bool(jnp.all(jnp.isfinite(res.state.energy))),
          "blocked energies are not finite")


def _chain_stats(spec, state):
    """Per-chain energy per particle and well-A/B particle fractions."""
    from flowstate.analysis import classify_particles

    half_box = float(spec.box.size_x) / 2
    labels = classify_particles(np.asarray(state.positions), half_box,
                                spec.r0)
    return {"energy_per_particle": np.asarray(state.energy, np.float64)
            / spec.num_particles,
            "occupancy_A": (labels == 0).mean(axis=-1),
            "occupancy_B": (labels == 1).mean(axis=-1)}


@phase("d (Metropolis kernel vs plain engine)")
def phase_d() -> None:
    import jax
    import jax.numpy as jnp

    from flowstate.mcmc import (
        init_alternating_wells, init_chain_state, resync_energy, run_moves,
    )
    from flowstate.mcmc.pallas_metropolis import run_moves_pallas
    from flowstate.ops import Box, SystemSpec

    moves = 4096
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    pos, _ = init_alternating_wells(NUM_CHAINS, 3, 0.03)
    state = init_chain_state(spec, jnp.asarray(pos), jax.random.key(0),
                             0.65)
    kern = jax.jit(lambda s: run_moves_pallas(spec, 1.0, s, moves))(state)
    plain = jax.jit(jax.vmap(lambda s: run_moves(spec, 1.0, s, moves)))(
        state)
    acc_k = float(jnp.mean(kern.accepts / kern.attempts))
    acc_p = float(jnp.mean(plain.accepts / plain.attempts))
    print(f"  acceptance kernel={acc_k} plain={acc_p}")
    check(abs(acc_k - acc_p) <= ACCEPTANCE_TOL,
          "kernel and plain acceptance differ by more than 0.02")

    resynced = resync_energy(spec, kern)
    drift = float(jnp.max(jnp.abs(kern.energy - resynced.energy)
                          / jnp.abs(resynced.energy)))
    print(f"  kernel cached-energy max relative drift={drift}")
    check(drift <= RESYNC_REL_TOL, "kernel cached energies drifted")

    sk, sp = _chain_stats(spec, resynced), _chain_stats(spec, plain)
    for name in sk:
        a, b = sk[name], sp[name]
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        print(f"  {name}: kernel={a.mean()} plain={b.mean()} se={se}")
        check(abs(a.mean() - b.mean()) <= SE_MULTIPLE * se,
              f"kernel and plain {name} differ by more than 3 SE")

    sys.path.insert(0, os.path.join(REPO, "tests"))
    path = os.path.join(REPO, "tests", "test_pallas_metropolis.py")
    spec_ = importlib.util.spec_from_file_location("gpu_tests", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    for name in sorted(vars(mod)):
        fn = getattr(mod, name)
        marks = getattr(fn, "pytestmark", [])
        if name.startswith("test_") and any(m.name == "gpu" for m in marks):
            fn()
            print(f"  {name}: passed")


@phase("e (flow numerics)")
def phase_e() -> None:
    import jax
    import jax.numpy as jnp

    from flowstate.flows import build_circular_flow
    from flowstate.mcmc import (
        apply_big_moves, init_chain_state, resync_energy,
    )
    from flowstate.mcmc.hybrid import to_box_frame, to_centered
    from flowstate.ops import Box, SystemSpec

    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    hb = float(spec.box.size_x) / 2
    model = build_circular_flow(3, 2, hb, K=15, hidden_units=256,
                                num_bins=32, num_blocks=2)
    params = model.init_params(jax.random.key(7))
    x = jax.random.uniform(jax.random.key(8), (NUM_CHAINS, 6),
                           minval=-hb, maxval=hb)

    log_prob = jax.jit(model.log_prob)
    lp_default = np.asarray(log_prob(params, x), np.float64)
    with jax.default_matmul_precision("highest"):
        lp_highest = np.asarray(jax.jit(model.log_prob)(params, x),
                                np.float64)
    cpu = jax.devices("cpu")[0]
    lp_cpu = np.asarray(jax.jit(model.log_prob)(
        jax.device_put(params, cpu), jax.device_put(x, cpu)), np.float64)
    err = {"default_vs_highest": np.max(np.abs(lp_default - lp_highest)),
           "default_vs_cpu": np.max(np.abs(lp_default - lp_cpu)),
           "highest_vs_cpu": np.max(np.abs(lp_highest - lp_cpu))}

    z = jax.random.uniform(jax.random.key(9), (NUM_CHAINS, 6),
                           minval=-hb, maxval=hb)
    back = jax.jit(lambda p, zz: model.inverse(p, model.forward(p, zz)))(
        params, z)
    d = np.asarray(back, np.float64) - np.asarray(z, np.float64)
    d -= 2 * hb * np.round(d / (2 * hb))          # circular coordinates
    err["round_trip"] = np.max(np.abs(d))

    @jax.jit
    def self_proposal(s):
        s = resync_energy(spec, s)
        lq = model.log_prob(params, to_centered(s.positions, hb))
        return apply_big_moves(spec, 1.0, s, s.positions, lq, model,
                               params, hb, jnp.full(lq.shape, 0.5))

    pos = to_box_frame(model.sample(params, jax.random.key(10), 4096), 3, hb)
    res = self_proposal(init_chain_state(spec, pos, jax.random.key(11)))
    finite = np.isfinite(np.asarray(res.ratio_log))
    err["self_proposal_max_abs_ratio"] = float(np.max(np.abs(
        np.asarray(res.ratio_log)[finite]))) if finite.any() else 0.0
    print("  max errors: " + json.dumps({k: float(v) for k, v in err.items()}))
    check(err["default_vs_highest"] <= LOG_PROB_ABS_TOL,
          "log_prob at default precision differs from 'highest'")
    check(err["default_vs_cpu"] <= LOG_PROB_ABS_TOL,
          "log_prob on the card differs from the CPU")
    check(err["highest_vs_cpu"] <= LOG_PROB_ABS_TOL,
          "log_prob at 'highest' differs from the CPU")
    check(err["round_trip"] <= ROUND_TRIP_ABS_TOL,
          "sample -> inverse round trip error too large")
    check(err["self_proposal_max_abs_ratio"] == 0.0,
          "self-proposal MH log-ratio is not exactly 0")


@phase("f (four cards)")
def phase_f() -> None:
    sys.path.insert(0, REPO)
    import __graft_entry__

    checks = __graft_entry__.dryrun_multichip(4)
    print("  " + json.dumps(checks))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card phase")
    args = parser.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 2
    if args.four_cards and len(devices) < 4:
        print(f"--four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from flowstate.utils.profiling import (
        enable_compilation_cache, gpu_name_and_power,
    )

    print(gpu_name_and_power())
    enable_compilation_cache()
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    if args.four_cards:
        phase_f()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase_a(tmp)
        phase_b()
        phase_c()
        phase_d()
        phase_e()
    print(gpu_name_and_power())
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
