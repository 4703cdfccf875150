"""The hybrid beyond N=3: flow training, big-move acceptance, and ΔF
validation against parallel tempering at N = 8, 16, 32.

VERDICT r3 item 1: every validated physics result so far is N=3 (6 flow
features), yet the framework's scaling story is chains AND particle count
(SURVEY.md §5/§7; the reference exposes N as a first-class flag,
MCMC/main.py:16-50, and SimpleLJ.py:15-39 is generic-N).  Independence-
proposal acceptance is known to collapse with dimension; this tool
measures that wall and its mitigation.

Per particle count N:

1. init chains split between the wells (alternating low-left/low-right
   for N<=12, alternating half-box lattices above), equilibrate.
2. collect local-MCMC training data (the A1 recipe,
   main_algorithm_1.py:240-253).
3. run PARALLEL TEMPERING — the flow-free rare-event oracle that scales —
   recording (a) the cold-replica particle-level ΔF = ln(E[n_B]/E[n_A])
   and (b) cold-replica configurations as an alternative training set
   (the A1 "premade data" variant, run_algo_1_v_0.00_premade_data.ipynb).
4. for each training set {local, pt}: train the circular-spline flow
   (2N features), measure big-move acceptance, run the hybrid A1
   schedule {local moves + 1 big move}/round, and compute the well-state
   ESS/s and the hybrid's particle-level ΔF.

The local-vs-pt comparison separates the two acceptance-collapse causes:
sector coverage of the training data (local chains cannot cross, so
their data has only the init sectors) vs the dimension itself.

Writes results/evidence/hybrid_n_scaling.json; the table lands in
RESULTS.md (hand-edited from the JSON).

Usage (on the GPU): python tools/hybrid_n_scaling.py --n_list 8,16,32
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.utils.profiling import enable_compilation_cache

try:
    enable_compilation_cache()
except Exception:
    pass

from ess_check import well_counts, well_state

from flowstate.analysis.ess import crossing_bound_ess, multichain_ess
from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    init_chain_state, init_tempered_state, nf_big_moves, run_equilibration,
    run_moves, run_replica_exchange, temperature_ladder,
)
from flowstate.mcmc.hybrid import to_centered
from flowstate.mcmc.initialise import (
    init_alternating_wells, initialise_fcc_left_half,
    initialise_fcc_right_half,
)
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig, train


def _timed(fn, *args):
    # TWO untimed warmups: the first 1-2 executions of a fresh program run
    # ~2x slow (the r4 warmup trap, logs/train_variance_r4.log) — a single
    # warmup times the slow tail and understates throughput up to ~2x
    out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    out = fn(*args)
    out = jax.device_get(out)
    return out, time.perf_counter() - t0


def _ess_fields(ess: float, ess_ub: float, dt: float,
                reliable: bool) -> dict:
    """Headline ESS fields with the unreliable-estimator suppression rule.

    When the observed crossings cannot support the rank-normalized
    estimate (``reliable=False``), the estimator fields are NULLED and the
    crossing-rate BOUND is the headline (SAMPLERS.md's own convention) —
    any consumer of the JSON otherwise reads a number up to ~13x above
    what the data supports (VERDICT r4 weak item 2 / next item 6).
    """
    out = {
        "well_ess": round(ess, 1) if reliable else None,
        "well_ess_per_s": round(ess / dt, 2) if reliable else None,
        "well_ess_upper_bound": round(ess_ub, 1),
        "well_ess_per_s_upper_bound": round(ess_ub / dt, 2),
        "ess_reliable": reliable,
    }
    if not reliable:
        out["well_ess_suppressed_estimate"] = round(ess, 1)
    return out


def resuppress(path: str) -> None:
    """Apply the suppression rule to an existing evidence JSON in place."""
    doc = json.load(open(path))
    for sys_row in doc.get("systems", []):
        for key in ("local_trained", "pt_trained"):
            var = sys_row.get(key)
            if not var or var.get("ess_reliable", True):
                continue
            ess = var.get("well_ess_suppressed_estimate")
            if ess is None:
                ess = var.get("well_ess")
            dt = var.get("wall_s", 1.0)
            var.update(_ess_fields(float(ess), float(
                var["well_ess_upper_bound"]), float(dt), False))
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"resuppressed unreliable ESS fields in {path}")


def init_split_wells(chains: int, n: int, rho: float):
    """(C, N, 2) alternating-well starts for any N."""
    if n <= 12:
        pos, box = init_alternating_wells(chains, n, rho)
        return jnp.asarray(pos), box
    left, box = initialise_fcc_left_half(n, rho, 1.0)
    right, _ = initialise_fcc_right_half(n, rho, 1.0)
    pos = np.stack([left if i % 2 == 0 else right for i in range(chains)])
    return jnp.asarray(pos), box


def run_for_n(n: int, args) -> dict:
    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    beta = 1.0
    half_box = float(spec.box.size_x) / 2
    out = {"n": n, "chains": c, "rounds": rounds, "moves_per_round": mpr,
           "box_l": 2 * half_box}

    pos, _ = init_split_wells(c, n, 0.03)
    state0 = init_chain_state(spec, pos, jax.random.key(n), 0.65)
    # 20k steps: the half-lattice starts at N=16/32 are ~150-300 sweeps
    # from the packed-well equilibrium at 5k (cheap on the XLA engine)
    state0 = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, 20000, 500)))(state0)
    jax.block_until_ready(state0.positions)
    print(f"N={n}: equilibrated {c} chains "
          f"(E/N={float(state0.energy.mean())/n:.2f})", flush=True)

    # ---- 2) local training data (A1 recipe) ----------------------------
    @jax.jit
    def collect(s):
        def body(st, _):
            st = jax.vmap(lambda t: run_moves(spec, beta, t, mpr))(st)
            return st, st.positions
        return jax.lax.scan(body, s, None, length=args.collect_rounds)

    s_coll, configs = collect(state0)
    data_local = to_centered(jnp.reshape(configs, (-1, n, 2)), half_box)
    print(f"N={n}: collected {data_local.shape[0]} local configs", flush=True)

    # ---- 3) parallel tempering oracle + data ---------------------------
    r = args.replicas
    walkers = c // r
    betas = temperature_ladder(1.0, args.t_hot, r)
    pos_pt, _ = init_split_wells(walkers, n, 0.03)
    st_pt = init_tempered_state(
        spec, jnp.broadcast_to(jnp.asarray(pos_pt), (r, walkers, n, 2)),
        jax.random.key(100 + n), 0.65)
    st_pt = jax.jit(jax.vmap(lambda b, s: jax.vmap(
        lambda t: run_equilibration(spec, b, t, 2000, 500))(s)))(betas, st_pt)
    jax.block_until_ready(st_pt.positions)

    pt_rounds = args.pt_rounds

    @jax.jit
    def pt(st):
        return run_replica_exchange(
            spec, betas, st, jax.random.key(200 + n), pt_rounds, mpr,
            record="cold",
            record_fn=lambda s: (well_state(spec, s.positions[0]),
                                 well_counts(spec, s.positions[0]),
                                 s.positions[0]))

    res, dt_pt = _timed(pt, st_pt)
    w_pt, (na_pt, nb_pt), cold_pos = res.extras
    burn_pt = pt_rounds // 3
    w_pt = np.asarray(w_pt).T
    ess_pt = multichain_ess(w_pt[:, burn_pt:])
    cross_pt = int(np.sum(np.abs(np.diff(w_pt, axis=1)) > 0.5))
    df_pt = float(np.log(max(nb_pt[burn_pt:].sum(), 1.0)
                         / max(na_pt[burn_pt:].sum(), 1.0)))
    out["pt"] = {"df_particle": round(df_pt, 4), "wall_s": round(dt_pt, 2),
                 "crossings": cross_pt,
                 "well_ess": round(float(ess_pt), 1),
                 "well_ess_per_s": round(float(ess_pt) / dt_pt, 2),
                 "edge_acceptance": [round(float(a), 3)
                                     for a in np.asarray(
                                         res.edge_acceptance)],
                 "ladder": f"{r}x{walkers}, T_hot={args.t_hot}"}
    print(f"N={n}: PT dF={df_pt:.4f} ({cross_pt} crossings, "
          f"{dt_pt:.1f}s)", flush=True)

    data_pt = to_centered(
        jnp.reshape(jnp.asarray(cold_pos)[burn_pt:], (-1, n, 2)), half_box)

    # ---- 4) flows + hybrid for each training set -----------------------
    def cap(data):
        if data.shape[0] > args.train_cap:
            idx = np.linspace(0, data.shape[0] - 1, args.train_cap,
                              dtype=np.int64)
            data = data[jnp.asarray(idx)]
        return data

    model = build_circular_flow(n, 2, half_box, K=args.K,
                                hidden_units=args.hidden,
                                num_bins=args.bins, num_blocks=2)

    def hybrid_variant(tag, data):
        params = model.init_params(jax.random.key(1))
        tcfg = TrainConfig(batch_size=512, epochs=args.epochs, lr=1e-4)
        t0 = time.perf_counter()
        params, _, _, loss_epoch = train(model, params, cap(data), tcfg,
                                         jax.random.key(2))
        dt_train = time.perf_counter() - t0
        var = {"train_configs": int(min(data.shape[0], args.train_cap)),
               "train_wall_s": round(dt_train, 1),
               "fkld_first": round(float(loss_epoch[0]), 3),
               "fkld_last": round(float(loss_epoch[-1]), 3)}

        # big-move acceptance, measured over acc_rounds fresh proposals
        @jax.jit
        def acc_rounds_fn(s):
            def body(st, _):
                r1 = nf_big_moves(spec, beta, st, model, params, half_box)
                return r1.state, jnp.mean(r1.accepted.astype(jnp.float32))
            return jax.lax.scan(body, s, None, length=args.acc_rounds)

        _, acc_series = acc_rounds_fn(state0)
        acc_big = float(jnp.mean(acc_series))
        var["big_move_acceptance"] = round(acc_big, 5)

        # hybrid production: {mpr local + 1 big}/round
        def hybrid_move(st):
            st = jax.vmap(lambda t: run_moves(spec, beta, t, mpr))(st)
            return nf_big_moves(spec, beta, st, model, params, half_box).state

        @jax.jit
        def hybrid(s):
            def body(st, _):
                st = hybrid_move(st)
                return st, (well_state(spec, st.positions),
                            well_counts(spec, st.positions))
            s, (w, (n_a, n_b)) = jax.lax.scan(body, s, None, length=rounds)
            return s, w, n_a, n_b

        (s_end, w, n_a, n_b), dt = _timed(hybrid, state0)
        burn = rounds // 3
        w = np.asarray(w).T
        ess = multichain_ess(w[:, burn:])
        ess_ub = crossing_bound_ess(w[:, burn:])
        crossings = int(np.sum(np.abs(np.diff(w, axis=1)) > 0.5))
        df = float(np.log(max(n_b[burn:].sum(), 1.0)
                          / max(n_a[burn:].sum(), 1.0)))
        reliable = crossings >= 20 and ess <= ess_ub
        var.update(_ess_fields(float(ess), float(ess_ub), dt, reliable))
        var.update({
            "wall_s": round(dt, 2), "crossings": crossings,
            "df_particle": round(df, 4),
            "df_vs_pt": round(df - df_pt, 4),
        })
        print(f"N={n} [{tag}]: acc={acc_big:.4f} dF={df:.4f} "
              f"(PT {df_pt:.4f}) crossings={crossings} "
              f"ESS/s={float(ess)/dt:.1f}", flush=True)
        return var

    out["local_trained"] = hybrid_variant("local", data_local)
    out["pt_trained"] = hybrid_variant("pt", data_pt)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_list", default="8,16,32")
    ap.add_argument("--chains", type=int, default=510,
                    help="divisible by --replicas keeps PT walkers even")
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--collect_rounds", type=int, default=100)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--acc_rounds", type=int, default=50)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--train_cap", type=int, default=102_400)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--K", type=int, default=15)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--bins", type=int, default=32)
    ap.add_argument("--json_out",
                    default="results/evidence/hybrid_n_scaling.json")
    ap.add_argument("--resuppress", action="store_true",
                    help="only re-apply the unreliable-ESS suppression "
                         "rule to the existing JSON (no device run)")
    args = ap.parse_args(argv)

    if args.resuppress:
        resuppress(args.json_out)
        return None

    results = {"metric": "hybrid_n_scaling",
               "device": str(jax.devices()[0]),
               "flow": f"K={args.K} hidden={args.hidden} bins={args.bins}",
               "systems": []}
    for n in [int(x) for x in args.n_list.split(",")]:
        results["systems"].append(run_for_n(n, args))
        # checkpoint after every N (each takes many minutes)
        os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"metric": "hybrid_n_scaling",
                      "n_done": [s["n"] for s in results["systems"]]}))
    return results


if __name__ == "__main__":
    main()
