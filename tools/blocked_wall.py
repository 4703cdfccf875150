"""Engineering past the N-wall: blocked conditional-flow proposals.

Round 4 measured the GLOBAL independence proposal's acceptance law
ln(acc) = -1.006 N + 1.04 (one decade per ~2.3 particles) and diagnosed
its cause (coordinate-wise couplings cannot encode exclusion volume —
``results/evidence/n_mitigation.json``).  This tool tests the structural
fix (VERDICT r4 item 1): resample k particles from a flow conditioned on
the other N-k (``mcmc/blocked.py``), whose acceptance the decay law
predicts at ~ e * 10^(-k/2.3) *independent of N*.

Per particle count N:
  1. equilibrate chains split between wells;
  2. run the PT oracle (df_pt + cold-replica training data — the
     sector-complete training set, as in tools/hybrid_n_scaling.py);
  3. per block size k: train the conditional flow on the PT data,
     measure (a) blocked-move acceptance, (b) a hybrid production run
     {local moves + one blocked sweep}/round -> well-state crossings,
     ESS (with the unreliable-estimator suppression rule) and the
     particle-level dF vs the PT oracle.

Writes results/evidence/blocked_wall.json.  The acceptance-vs-k table
and its N-(in)dependence are the headline; the dF agreement is the
correctness gate.

Usage (on the GPU): python tools/blocked_wall.py --n_list 8,16,32
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
from hybrid_n_scaling import _ess_fields, _timed, init_split_wells

from flowstate.analysis.ess import crossing_bound_ess, multichain_ess
from flowstate.flows import build_conditional_circular_flow
from flowstate.mcmc import (
    blocked_big_moves, fourier_context, fourier_context_dim,
    init_chain_state, init_tempered_state, run_equilibration, run_moves,
    run_replica_exchange, temperature_ladder,
)
from flowstate.mcmc.blocked import block_context, context_dim
from flowstate.mcmc.hybrid import to_centered
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig
from flowstate.training.blocked import train_blocked


def make_context(args, n: int, k: int, half_box: float):
    if args.context == "fourier":
        fn = lambda r, p: fourier_context(r, p, half_box,  # noqa: E731
                                          m_max=args.m_max)
        return fn, fourier_context_dim(args.m_max)
    fn = lambda r, p: block_context(r, p, half_box)        # noqa: E731
    return fn, context_dim(n, k)


def run_for_n(n: int, args) -> dict:
    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=args.r0, k=15.0)
    beta = 1.0
    half_box = float(spec.box.size_x) / 2
    out = {"n": n, "chains": c, "rounds": rounds, "moves_per_round": mpr,
           "box_l": 2 * half_box}

    pos, _ = init_split_wells(c, n, 0.03)
    state0 = init_chain_state(spec, pos, jax.random.key(n), 0.65)
    state0 = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, 20000, 500)))(state0)
    jax.block_until_ready(state0.positions)
    print(f"N={n}: equilibrated {c} chains "
          f"(E/N={float(state0.energy.mean())/n:.2f})", flush=True)

    # ---- PT oracle + sector-complete training data ---------------------
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

    @jax.jit
    def pt(st):
        return run_replica_exchange(
            spec, betas, st, jax.random.key(200 + n), args.pt_rounds, mpr,
            record="cold",
            record_fn=lambda s: (well_counts(spec, s.positions[0]),
                                 s.positions[0]))

    res, dt_pt = _timed(pt, st_pt)
    (na_pt, nb_pt), cold_pos = res.extras
    burn_pt = args.pt_rounds // 3
    df_pt = float(np.log(max(nb_pt[burn_pt:].sum(), 1.0)
                         / max(na_pt[burn_pt:].sum(), 1.0)))
    out["pt"] = {"df_particle": round(df_pt, 4), "wall_s": round(dt_pt, 2),
                 "ladder": f"{r}x{walkers}, T_hot={args.t_hot}"}
    print(f"N={n}: PT dF={df_pt:.4f} ({dt_pt:.1f}s)", flush=True)

    data_pt = jnp.reshape(jnp.asarray(cold_pos)[burn_pt:], (-1, n, 2))
    out["train_configs"] = int(data_pt.shape[0])

    # ---- blocked flow per k -------------------------------------------
    out["blocks"] = []
    for k in [int(x) for x in args.k_list.split(",") if int(x) < n]:
        ctx_fn, ctx_dim = make_context(args, n, k, half_box)
        model = build_conditional_circular_flow(
            k, 2, half_box, context_features=ctx_dim, K=args.K,
            hidden_units=args.hidden, num_bins=args.bins, num_blocks=2)
        params = model.init_params(jax.random.key(1))
        tcfg = TrainConfig(batch_size=512, epochs=args.epochs, lr=args.lr)
        t0 = time.perf_counter()
        params, _, loss_epoch = train_blocked(
            model, params, data_pt, k, half_box, tcfg, jax.random.key(2),
            context_fn=ctx_fn)
        dt_train = time.perf_counter() - t0
        row = {"k": k, "context": args.context,
               "train_wall_s": round(dt_train, 1),
               "loss_first": round(float(loss_epoch[0]), 3),
               "loss_last": round(float(loss_epoch[-1]), 3),
               "predicted_acceptance": round(
                   float(np.e * 10 ** (-k / 2.3)), 5)}

        # acceptance over fresh proposals on the equilibrated ensemble
        @jax.jit
        def acc_fn(s):
            def body(st, _):
                r1 = blocked_big_moves(spec, beta, st, model, params,
                                       half_box, k, context_fn=ctx_fn)
                return r1.state, jnp.mean(r1.accepted.astype(jnp.float32))
            return jax.lax.scan(body, s, None, length=args.acc_rounds)

        _, acc_series = acc_fn(state0)
        acc = float(jnp.mean(acc_series))
        row["acceptance"] = round(acc, 5)

        # hybrid production: {mpr local + one blocked sweep}/round
        bpr = max(1, n // k)

        @jax.jit
        def hybrid(s):
            def body(st, _):
                st = jax.vmap(lambda t: run_moves(spec, beta, t, mpr))(st)

                def blk(st2, _):
                    return blocked_big_moves(
                        spec, beta, st2, model, params, half_box, k,
                        context_fn=ctx_fn).state, None
                st, _ = jax.lax.scan(blk, st, None, length=bpr)
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
        row.update(_ess_fields(float(ess), float(ess_ub), dt, reliable))
        row.update({
            "blocked_per_round": bpr, "wall_s": round(dt, 2),
            "crossings": crossings, "df_particle": round(df, 4),
            "df_vs_pt": round(df - df_pt, 4),
        })
        print(f"N={n} k={k}: acc={acc:.4f} (predicted "
              f"{row['predicted_acceptance']:.4f}) dF={df:.4f} "
              f"(PT {df_pt:.4f}) crossings={crossings}", flush=True)
        out["blocks"].append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_list", default="8,16,32")
    ap.add_argument("--k_list", default="1,2,3,4")
    ap.add_argument("--chains", type=int, default=510)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--acc_rounds", type=int, default=50)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--K", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--context", choices=("fourier", "coords"),
                    default="fourier")
    ap.add_argument("--m_max", type=int, default=3)
    ap.add_argument("--r0", type=float, default=1.2,
                    help="well radius: 1.2 = reference; larger separates "
                         "crowding from particle count (deep-well regime "
                         "at higher N)")
    ap.add_argument("--json_out",
                    default="results/evidence/blocked_wall.json")
    args = ap.parse_args(argv)

    results = {"metric": "blocked_wall",
               "device": str(jax.devices()[0]),
               "flow": f"K={args.K} hidden={args.hidden} bins={args.bins} "
                       f"context={args.context}(m_max={args.m_max})",
               "decay_law": "r4 global-proposal fit: ln(acc) = -1.006 N "
                            "+ 1.04; blocked prediction acc ~ e*10^(-k/2.3)"
                            " independent of N",
               "systems": []}
    for n in [int(x) for x in args.n_list.split(",")]:
        results["systems"].append(run_for_n(n, args))
        os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"metric": "blocked_wall",
                      "n_done": [s["n"] for s in results["systems"]]}))
    return results


if __name__ == "__main__":
    main()
