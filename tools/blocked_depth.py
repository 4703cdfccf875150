"""Conditional-flow depth sweep: how shallow can the blocked proposal go?

The blocked-move round's cost is the K-deep coupling chain, so flow depth is the direct throughput lever: the
paired sample + old-log_prob pass costs K serial coupling steps, each
with ~2 conditioner-net applications.  This tool asks whether the production config
(K=10, from the global-flow default) is deeper than the 2-dim k=1
conditional target needs: per K it trains the conditional flow on the
same PT oracle data, gates correctness (acceptance, well-ESS, particle
dF vs PT), and times the 16,384-chain production round exactly as
bench.py's blocked segment does.

If a shallower stack holds acceptance and the dF gate, it becomes the
recommended production depth (bench.py + README); if acceptance decays,
that measures the depth the conditional density actually needs.

Reference lineage: the depth knob is the reference's ``K`` stack count
(``hybrid_NF_MCMC/main_algorithm_1.py:57-67``, K=15 global); the
reference never separates proposal quality from proposal cost.

Usage (on the GPU): python tools/blocked_depth.py --K_list 4,6,10
Writes results/evidence/blocked_depth.json.
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
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig
from flowstate.training.blocked import train_blocked

BENCH_CHAINS = 16384  # bench.py's production ensemble
ROUNDS_PER_CALL = 64
BIG_CALLS = 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--K_list", default="4,6,10")
    ap.add_argument("--hidden_list", default="128",
                    help="comma list; crossed with K_list")
    ap.add_argument("--chains", type=int, default=510)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--acc_rounds", type=int, default=50)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--m_max", type=int, default=3)
    ap.add_argument("--skip_throughput", action="store_true",
                    help="CPU smoke: skip the 16,384-chain timed segment")
    ap.add_argument("--json_out",
                    default="results/evidence/blocked_depth.json")
    args = ap.parse_args(argv)

    n, k = args.n, args.k
    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    beta = 1.0
    half_box = float(spec.box.size_x) / 2
    ctx_fn = lambda r, p: fourier_context(r, p, half_box,  # noqa: E731
                                          m_max=args.m_max)
    ctx_dim = fourier_context_dim(args.m_max)

    pos, _ = init_split_wells(c, n, 0.03)
    state0 = init_chain_state(spec, pos, jax.random.key(n), 0.65)
    state0 = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, 20000, 500)))(state0)
    jax.block_until_ready(state0.positions)
    print(f"N={n}: equilibrated {c} chains", flush=True)

    # ---- PT oracle + training data, ONCE (identical recipe to
    # tools/blocked_wall.py so rows are comparable) -----------------------
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
    data_pt = jnp.reshape(jnp.asarray(cold_pos)[burn_pt:], (-1, n, 2))
    print(f"N={n}: PT dF={df_pt:.4f}, {int(data_pt.shape[0])} train configs",
          flush=True)

    out = {"metric": "blocked_depth", "n": n, "k": k,
           "device": str(jax.devices()[0]),
           "context": f"fourier(m_max={args.m_max})", "bins": args.bins,
           "pt": {"df_particle": round(df_pt, 4),
                  "ladder": f"{r}x{walkers}, T_hot={args.t_hot}"},
           "bench_chains": BENCH_CHAINS, "rows": []}

    if not args.skip_throughput:
        pos_b, _ = init_split_wells(BENCH_CHAINS, n, 0.03)
        st_bench0 = init_chain_state(spec, jnp.asarray(pos_b),
                                     jax.random.key(22), 0.65)

    for K in [int(x) for x in args.K_list.split(",")]:
        for hidden in [int(x) for x in args.hidden_list.split(",")]:
            model = build_conditional_circular_flow(
                k, 2, half_box, context_features=ctx_dim, K=K,
                hidden_units=hidden, num_bins=args.bins, num_blocks=2)
            params = model.init_params(jax.random.key(1))
            tcfg = TrainConfig(
                batch_size=min(512, int(data_pt.shape[0])),
                epochs=args.epochs, lr=args.lr)
            t0 = time.perf_counter()
            params, _, loss_epoch = train_blocked(
                model, params, data_pt, k, half_box, tcfg,
                jax.random.key(2), context_fn=ctx_fn)
            row = {"K": K, "hidden": hidden,
                   "train_wall_s": round(time.perf_counter() - t0, 1),
                   "loss_last": round(float(loss_epoch[-1]), 3)}

            @jax.jit
            def acc_fn(s):
                def body(st, _):
                    r1 = blocked_big_moves(spec, beta, st, model, params,
                                           half_box, k, context_fn=ctx_fn)
                    return r1.state, jnp.mean(
                        r1.accepted.astype(jnp.float32))
                return jax.lax.scan(body, s, None, length=args.acc_rounds)

            _, acc_series = acc_fn(state0)
            row["acceptance"] = round(float(jnp.mean(acc_series)), 5)

            bpr = max(1, n // k)

            @jax.jit
            def hybrid(s):
                def body(st, _):
                    st = jax.vmap(
                        lambda t: run_moves(spec, beta, t, mpr))(st)

                    def blk(st2, _):
                        return blocked_big_moves(
                            spec, beta, st2, model, params, half_box, k,
                            context_fn=ctx_fn).state, None
                    st, _ = jax.lax.scan(blk, st, None, length=bpr)
                    return st, (well_state(spec, st.positions),
                                well_counts(spec, st.positions))
                s, (w, (n_a, n_b)) = jax.lax.scan(body, s, None,
                                                  length=rounds)
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
            row.update({"wall_s": round(dt, 2), "crossings": crossings,
                        "df_particle": round(df, 4),
                        "df_vs_pt": round(df - df_pt, 4)})

            # ---- bench.py's production-round segment: 16,384 chains,
            # ROUNDS_PER_CALL rounds per dispatch, two warmups ------------
            if not args.skip_throughput:
                @jax.jit
                def blocked_rounds(s1):
                    def body(carry, _):
                        return blocked_big_moves(
                            spec, beta, carry, model, params, half_box, k,
                            context_fn=ctx_fn).state, None
                    s2, _ = jax.lax.scan(body, s1, None,
                                         length=ROUNDS_PER_CALL)
                    return s2

                sb = blocked_rounds(st_bench0)
                sb = blocked_rounds(sb)
                jax.block_until_ready(sb.energy)
                t0 = time.perf_counter()
                for _ in range(BIG_CALLS):
                    sb = blocked_rounds(sb)
                jax.block_until_ready(sb.energy)
                dt_blk = time.perf_counter() - t0
                rps = ROUNDS_PER_CALL * BIG_CALLS / dt_blk
                row["blocked_moves_per_s"] = round(BENCH_CHAINS * rps, 1)

            print(f"K={K} h={hidden}: acc={row['acceptance']:.4f} "
                  f"dF={df:.4f} (PT {df_pt:.4f}) "
                  f"ESS/s={row.get('well_ess_per_s')} "
                  f"moves/s={row.get('blocked_moves_per_s')}", flush=True)
            out["rows"].append(row)
            os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(out, f, indent=1)

    print(json.dumps({"metric": "blocked_depth",
                      "rows": len(out["rows"])}))
    return out


if __name__ == "__main__":
    main()
