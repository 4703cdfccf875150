"""Cross-sampler comparison on the LJ double well -> SAMPLERS.md.

One system (the reference's full-scale N=3 double well), one budget shape
(rounds x moves), five samplers:

  1. plain Metropolis     (the reference's only sampler)
  2. MALA                 (beyond-reference: jax.grad Langevin drifts)
  3. HMC                  (beyond-reference: multi-step leapfrog trajectories)
  4. parallel tempering   (beyond-reference: replica exchange)
  5. NF-hybrid            (the reference's Algorithm-1 recipe)

For each: wall time (fully fused device programs — one scan per sampler),
move acceptance, the SLOW observable's ESS (majority-in-B well state,
rank-normalized multichain estimator), ESS/s, and the particle-level
ΔF = ln(E[n_B]/E[n_A]) against the exact sector quadrature.  The point the
table makes quantitatively: gradient information (MALA, and even long
HMC trajectories) does NOT help with 10 k_BT barriers — only the
collective mechanisms (PT, NF teleports) turn wall-clock into barrier
crossings, and only they are allowed an ESS/s headline (pinned chains
gate out, ess_check.py semantics).

Usage (on the GPU): python tools/sampler_bench.py
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

from ess_check import exact_particle_df, well_counts, well_state

from flowstate.analysis.ess import multichain_ess
from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    init_alternating_wells, init_chain_state, init_tempered_state,
    nf_big_moves, run_equilibration, run_mala, run_mala_equilibration,
    run_moves, run_replica_exchange, temperature_ladder,
)
from flowstate.mcmc.hybrid import to_centered
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig, train


def _timed(fn, *args):
    """Compile+warm once, then time a second identical run (device wall)."""
    out = fn(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    out = fn(*args)
    out = jax.device_get(out)
    return out, time.perf_counter() - t0


from flowstate.analysis.ess import crossing_bound_ess as \
    _crossing_bound_ess  # noqa: E402  (shared with ess_check.py)


def _summary(name, obs, counts_ab, dt, acc, burn_frac=1 / 3):
    """obs: (C, T) well-state series; counts_ab: (n_a, n_b) over post-burn
    samples or None."""
    t = obs.shape[1]
    burn = int(t * burn_frac)
    ess = multichain_ess(obs[:, burn:])
    crossings = int(np.sum(np.abs(np.diff(obs, axis=1)) > 0.5))
    ess_ub = _crossing_bound_ess(obs[:, burn:])
    row = {
        "sampler": name, "wall_s": round(dt, 2),
        "acceptance": round(float(acc), 4),
        "well_ess": round(float(ess), 1),
        "well_ess_per_s": round(float(ess) / dt, 2),
        "crossings": crossings,
        # reliability needs BOTH enough crossings for the autocorrelation
        # estimate AND self-consistency with the crossing-rate bound: a
        # pinned ensemble's between-chain spread can inflate the
        # rank-normalized estimate far past what its crossings can support
        # (measured: plain at 33 crossings reported ESS 4109 vs bound 79)
        "ess_reliable": crossings >= 20 and ess <= ess_ub,
        # crossing-rate ESS upper bound (always finite; the honest number
        # for pinned samplers whose autocorrelation is unmeasurable)
        "well_ess_upper_bound": round(float(ess_ub), 1),
        "well_ess_per_s_upper_bound": round(float(ess_ub) / dt, 2),
    }
    if counts_ab is not None:
        n_a, n_b = counts_ab
        row["df_particle"] = round(float(np.log(max(n_b, 1.0)
                                                / max(n_a, 1.0))), 4)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--t_hot", type=float, default=10.0)  # TEMPERING.md ladder
    ap.add_argument("--train_cap", type=int, default=102_400,
                    help="subsample training configs to the reference A1 "
                         "budget (main_algorithm_1.py:57) so bench-scale "
                         "chain counts do not inflate the training phase")
    ap.add_argument("--samplers", default="plain,mala,hmc,pt,hybrid",
                    help="comma list; e.g. 'plain,hybrid' for the "
                         "full-chip ESS headline run")
    ap.add_argument("--json_out", default=None,
                    help="also write the result JSON to this path")
    ap.add_argument("--out", default="SAMPLERS.md")
    args = ap.parse_args(argv)
    which = set(args.samplers.split(","))

    c, rounds, mpr = args.chains, args.rounds, args.moves_per_round
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    beta = 1.0
    half_box = float(spec.box.size_x) / 2

    positions, _ = init_alternating_wells(c, 3, 0.03)
    state0 = init_chain_state(spec, jnp.asarray(positions),
                              jax.random.key(0), 0.65)
    state0 = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, 5000, 500)))(state0)
    jax.block_until_ready(state0.positions)
    print(f"equilibrated {c} chains", flush=True)

    def record(s):
        n_a, n_b = well_counts(spec, s.positions)
        return well_state(spec, s.positions), n_a, n_b

    def scan_rounds(move_fn):
        @jax.jit
        def run(s):
            def body(st, _):
                st = move_fn(st)
                return st, record(st)
            s, (w, n_a, n_b) = jax.lax.scan(body, s, None, length=rounds)
            return s, w, n_a, n_b
        return run

    rows = []
    burn = rounds // 3

    # ---- 1) plain Metropolis --------------------------------------------
    if "plain" in which:
        plain = scan_rounds(jax.vmap(lambda t: run_moves(spec, beta, t, mpr)))
        (s_end, w, n_a, n_b), dt = _timed(plain, state0)
        acc = (s_end.accepts - state0.accepts).sum() / (
            s_end.attempts - state0.attempts).sum()
        rows.append(_summary("plain Metropolis", np.asarray(w).T,
                             (n_a[burn:].sum(), n_b[burn:].sum()), dt, acc))
        print(rows[-1], flush=True)

    # ---- 2) MALA ---------------------------------------------------------
    if "mala" in which:
        mala0 = jax.jit(jax.vmap(lambda s: run_mala_equilibration(
            spec, beta, s, 1000, 100)))(state0._replace(
                max_disp=jnp.full_like(state0.max_disp, 0.02)))
        jax.block_until_ready(mala0.positions)
        mala = scan_rounds(jax.vmap(lambda t: run_mala(spec, beta, t, mpr)))
        (s_end, w, n_a, n_b), dt = _timed(mala, mala0)
        acc = (s_end.accepts - mala0.accepts).sum() / (
            s_end.attempts - mala0.attempts).sum()
        rows.append(_summary("MALA (grad drifts)", np.asarray(w).T,
                             (n_a[burn:].sum(), n_b[burn:].sum()), dt, acc))
        print(rows[-1], flush=True)

    # ---- 3) HMC ----------------------------------------------------------
    if "hmc" in which:
        from flowstate.mcmc import run_hmc, run_hmc_equilibration
        n_leap = 10
        hmc0 = jax.jit(jax.vmap(lambda s: run_hmc_equilibration(
            spec, beta, s, 500, 50, n_leap)))(state0._replace(
                max_disp=jnp.full_like(state0.max_disp, 0.05)))
        jax.block_until_ready(hmc0.positions)
        # n_leap-step trajectory costs n_leap+1 grads, so run mpr/n_leap
        # trajectories per round (same O(N^2)-pass count as the MALA row)
        traj = max(1, mpr // n_leap)
        hmc = scan_rounds(jax.vmap(
            lambda t: run_hmc(spec, beta, t, traj, n_leap)))
        (s_end, w, n_a, n_b), dt = _timed(hmc, hmc0)
        acc = (s_end.accepts - hmc0.accepts).sum() / (
            s_end.attempts - hmc0.attempts).sum()
        rows.append(_summary(f"HMC ({n_leap}-step leapfrog)",
                             np.asarray(w).T,
                             (n_a[burn:].sum(), n_b[burn:].sum()), dt, acc))
        rows[-1]["note"] = (
            f"{traj} trajectories/round x {n_leap + 1} grads = "
            f"{traj * (n_leap + 1)} grad evals/round vs MALA's "
            f"{2 * mpr} (2/move, uncached) — comparable, not "
            "strictly matched")
        print(rows[-1], flush=True)

    # ---- 4) parallel tempering ------------------------------------------
    r = args.replicas
    if "pt" in which:
        walkers = c // r
        betas = temperature_ladder(1.0, args.t_hot, r)
        # same alternating start, tiled over the ladder
        pos_pt, _ = init_alternating_wells(walkers, 3, 0.03)
        pos_pt = np.tile(np.asarray(pos_pt)[None], (r, 1, 1, 1))
        st_pt = init_tempered_state(spec, jnp.asarray(pos_pt),
                                    jax.random.key(3), 0.65)

        @jax.jit
        def pt(st):
            return run_replica_exchange(
                spec, betas, st, jax.random.key(4), rounds, mpr,
                record="cold",
                record_fn=lambda s: (well_state(spec, s.positions[0]),
                                     well_counts(spec, s.positions[0])))

        res, dt = _timed(pt, st_pt)
        w_pt, (n_a, n_b) = res.extras
        rows.append(_summary(
            f"parallel tempering ({r}x{walkers})", np.asarray(w_pt).T,
            (n_a[burn:].sum(), n_b[burn:].sum()), dt,
            float(np.mean(res.edge_acceptance))))
        rows[-1]["note"] = "acceptance = mean edge-swap rate"
        print(rows[-1], flush=True)

    # ---- 5) NF-hybrid ----------------------------------------------------
    dt_train = 0.0
    if "hybrid" in which:
        # flow trained on plain-phase production configs (A1 recipe)
        @jax.jit
        def collect(s):
            def body(st, _):
                st = jax.vmap(lambda t: run_moves(spec, beta, t, mpr))(st)
                return st, st.positions
            return jax.lax.scan(body, s, None, length=rounds)

        _, configs = collect(state0)
        data = to_centered(jnp.reshape(configs, (-1, 3, 2)), half_box)
        if data.shape[0] > args.train_cap:
            # uniform stride subsample to the A1 training budget: at
            # bench-scale chain counts the raw collection is millions of
            # configs, which would turn a sampler bench into a training bench
            idx = np.linspace(0, data.shape[0] - 1, args.train_cap,
                              dtype=np.int64)
            data = data[jnp.asarray(idx)]
        model = build_circular_flow(3, 2, half_box, K=15, hidden_units=256,
                                    num_bins=32, num_blocks=2)
        params = model.init_params(jax.random.key(1))
        t0 = time.perf_counter()
        tcfg = TrainConfig(batch_size=512, epochs=args.epochs, lr=1e-4)
        params, _, _, loss_epoch = train(model, params, data, tcfg,
                                         jax.random.key(2))
        dt_train = time.perf_counter() - t0
        print(f"flow trained on {int(data.shape[0])} configs: "
              f"fKLD {loss_epoch[0]:.2f} -> {loss_epoch[-1]:.2f} "
              f"in {dt_train:.1f}s", flush=True)

        def hybrid_move(st):
            st = jax.vmap(lambda t: run_moves(spec, beta, t, mpr))(st)
            return nf_big_moves(spec, beta, st, model, params,
                                half_box).state

        hybrid = scan_rounds(hybrid_move)
        (s_end, w, n_a, n_b), dt = _timed(hybrid, state0)
        # big-move acceptance: the state counters also include local moves,
        # so report the teleport acceptance from one extra jitted round.
        res1 = nf_big_moves(spec, beta, s_end, model, params, half_box)
        acc_big = float(jnp.mean(res1.accepted))
        rows.append(_summary("NF-hybrid (A1 schedule)", np.asarray(w).T,
                             (n_a[burn:].sum(), n_b[burn:].sum()), dt,
                             acc_big))
        rows[-1]["note"] = "acceptance = flow-teleport rate"
        rows[-1]["train_wall_s"] = round(dt_train, 1)
        print(rows[-1], flush=True)

    # seed-averaged oracle with its own MC error (ess_check.py docstring:
    # the old single-500k-sample constant 0.3947 sat 1.5 sigma high)
    exact_df, exact_df_sem = exact_particle_df()
    exact_df = round(exact_df, 4)
    # rigorous speedup: hybrid measured ESS/s over the plain CROSSING-RATE
    # upper bound (not the unmeasurable autocorrelation estimate)
    by_name = {r0["sampler"].split(" ")[0]: r0 for r0 in rows}
    speedup_lb = None
    if "plain" in by_name and "NF-hybrid" in by_name:
        plain_ub = by_name["plain"]["well_ess_per_s_upper_bound"]
        hyb = by_name["NF-hybrid"]
        if hyb["ess_reliable"] and plain_ub > 0:
            speedup_lb = round(hyb["well_ess_per_s"] / plain_ub, 1)
    result = {"metric": "sampler_bench", "rows": rows,
              "exact_df_particle": exact_df,
              "exact_df_particle_sem": round(exact_df_sem, 5),
              "hybrid_vs_plain_ess_speedup_lower_bound": speedup_lb,
              "budget": f"{c} chains x {rounds} rounds x {mpr} moves",
              "device": str(jax.devices()[0])}

    with open(args.out, "w") as f:
        f.write("# SAMPLERS — five samplers, one system, one budget\n\n")
        f.write(f"System: the reference full-scale N=3 double well "
                f"(V0 = -10/-10.5, ~10 k_BT barriers); budget "
                f"{c} chains x {rounds} rounds x {mpr} moves/round on "
                f"{jax.devices()[0].device_kind}.  Slow observable: "
                "majority-in-B well state; ESS: rank-normalized multichain "
                "(burn-in = first third).  Exact particle-level dF "
                f"(sector quadrature): **{exact_df}**.\n\n")
        f.write("| sampler | wall (s) | acceptance | crossings | well ESS "
                "| well ESS/s | dF (exact "
                f"{exact_df}) |\n|---|---|---|---|---|---|---|\n")
        for row in rows:
            ess_s = (f"**{row['well_ess_per_s']}**" if row["ess_reliable"]
                     else f"<= {row['well_ess_per_s_upper_bound']} "
                          f"(crossing-rate bound; {row['crossings']} "
                          "crossings)")
            f.write(f"| {row['sampler']} | {row['wall_s']} "
                    f"| {row['acceptance']} | {row['crossings']} "
                    f"| {row['well_ess']} | {ess_s} "
                    f"| {row.get('df_particle', '—')} |\n")
        n_leap_doc = 10
        f.write(
            "\nBudget accounting: the three local samplers run "
            f"{rounds}x{mpr} = {rounds * mpr:,} moves/chain.  Per move, "
            "plain Metropolis costs 1 per-particle energy (no gradients); "
            "MALA costs 2 full-system gradient evaluations (drift at x and "
            "at the proposal y, no caching across moves); HMC runs "
            f"{rounds * mpr}/{n_leap_doc} = {rounds * mpr // n_leap_doc:,} "
            f"trajectories of L={n_leap_doc} leapfrog steps, i.e. "
            f"{n_leap_doc + 1} gradient evaluations per trajectory = "
            f"{rounds * (mpr // n_leap_doc) * (n_leap_doc + 1):,} "
            f"grads/chain vs MALA's {rounds * mpr * 2:,} — comparable but "
            "not strictly matched gradient budgets (the rows are matched "
            "in *moves*, not grads).\n")
        f.write(
            "\nSamplers with <20 observed crossings — or whose rank-"
            "normalized estimate exceeds what their crossing count can "
            "support (a pinned ensemble's between-chain spread inflates "
            "it) — get no autocorrelation ESS; instead the table quotes "
            "the crossing-rate UPPER bound: "
            "for a stationary two-state chain ESS <= n*s/(2-s) with "
            "s = a+b <= 3.6*p (occupancies bounded in [1/6, 5/6] from the "
            "quadrature) and p the Poisson-95% UCL flip rate — finite even "
            "at zero crossings.\n")
        if speedup_lb is not None:
            f.write(f"\nNF-hybrid ESS/s over the plain crossing-rate bound: "
                    f"**>= {speedup_lb}x** (a true lower bound: the "
                    "numerator is measured, the denominator is an upper "
                    "bound).\n")
        f.write(
            "\nReading the table: plain Metropolis, MALA and HMC stay "
            "pinned at their initialization split — neither Langevin "
            "drifts nor long leapfrog trajectories cross 10 k_BT barriers, "
            "so their dF is the init artifact and their "
            "ESS is bounded by the (near-zero) crossing rate.  "
            "Parallel tempering and the NF-hybrid both reach equilibrium; "
            "their dF agrees with the exact quadrature and their ESS/s is "
            "the defensible headline.  The NF-hybrid pays a one-time "
            f"training cost ({dt_train:.1f} s here) amortized "
            "over every subsequent round.  The gradient samplers' actual "
            "job — within-well decorrelation — is MEASURED in the section "
            "below (tools/within_well_bench.py); tools/ess_check.py "
            "remains the plain-vs-hybrid capability artifact.\n")

    # re-splice the measured within-well section (separate tool's output)
    try:
        from within_well_bench import splice_into_samplers_md
        ww = json.load(open("results/evidence/within_well.json"))
        splice_into_samplers_md(ww, args.out)
    except (FileNotFoundError, ImportError):
        pass

    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
