"""ESS/s on the SLOW observable (well occupancy): hybrid vs plain MCMC.

bench.py's ESS/s is computed on the energy series — a *fast* observable
that plain Metropolis decorrelates fine.  The scientific reason this
framework exists is the slow observable: which well the configuration
occupies (wells ~10 k_BT deep; reference main_mcmc_only.py's whole point).
This tool measures, on the accelerator, the effective-sample-size rate of the
per-chain well-state label for

  (a) plain batched Metropolis (the reference's baseline, main_mcmc_only.py),
  (b) the NF-hybrid sampler (local moves + flow teleports,
      main_algorithm_1.py's testing schedule :375-422),

using identical chains and identical local-move budgets per recording
round.  ESS estimator: rank-normalized split-chain multi-chain ESS
(Vehtari et al. 2021; analysis/ess.py:multichain_ess), which mixes the
between-chain variance into the autocorrelation so chains pinned in one
well DEFLATE the estimate (the per-chain Geyer sum VERDICT.md round 1
flagged could not see pinning). Plain MCMC essentially never crosses
(PARITY.md: occupancies pinned at the init split), so its well-state ESS
is ~0 and the hybrid's ESS/s IS the capability.

Self-consistency gate: the tool refuses to print an ESS/s headline unless
the measured ΔF agrees with the exact quadrature value of the SAME
observable within 2 standard errors (SEM across chains) — an ESS claim
around a wrong mean is meaningless.  The observable here is PARTICLE-level
occupancy, whose exact value is ~0.392 (see ``exact_particle_df``), not
the pure-sector configuration ratio 1.490.

Writes ESS.md and prints one JSON line.

Usage: python tools/ess_check.py [--chains 256] [--rounds 400]
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

from flowstate.analysis.ess import (
    crossing_bound_ess, effective_sample_size, multichain_ess,
)
from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    init_alternating_wells, init_chain_state, nf_big_moves,
    run_equilibration, run_moves,
)
from flowstate.mcmc.hybrid import to_centered
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig, train
from flowstate.utils.profiling import enable_compilation_cache

WELL_RADIUS = 1.1 * 1.2  # classification circles (hybrid utils.py:104-141)


def exact_particle_df(samples: int = 4_000_000, seeds: int = 4):
    """Exact PARTICLE-level ΔF = ln(E[n_B]/E[n_A]) from the sector
    quadrature, with ITS OWN standard error.

    This tool's occupancy counts are per PARTICLE, and the equilibrium
    measure holds ~79% of its weight in particle-SPLIT sectors
    (SECTORS.md), so the particle-level ratio (~0.39) is a DIFFERENT
    observable from the pure-sector configuration ratio ln(Z_BBB/Z_AAA)
    = 1.490 — comparing the two was round 2's subtlest near-miss: the
    trained flow proposes split configurations, the hybrid chain reaches
    full equilibrium, and its particle-level ΔF is correct while looking
    "1.1 off" against the wrong constant.

    The quadrature is itself Monte Carlo, so the "exact" constant has
    sampling error — the single-500k-sample, seed-0 value this tool used
    through round 3 (0.3947) sits at the high edge of the estimator's
    distribution (measured: 500k-sample seed spread 0.392-0.396, std
    0.0014; converged 4Mx4-seed value 0.3926 +- 0.0003) and at full-chip
    chain counts (hybrid SEM ~0.003) that oracle error alone flipped the
    2-sigma gate.  Returns (mean, sem) over independent seeds; the gate
    must add sem in quadrature with the sampler's.
    """
    from exact_free_energy import exact_sector_probs

    vals = []
    for seed in range(seeds):
        p = exact_sector_probs(samples, seed=seed)
        n_b = p["AAB"] * 1 + p["ABB"] * 2 + p["BBB"] * 3
        n_a = p["AAA"] * 3 + p["AAB"] * 2 + p["ABB"] * 1
        vals.append(float(np.log(n_b / n_a)))
    return (float(np.mean(vals)),
            float(np.std(vals, ddof=1) / np.sqrt(len(vals))))


def well_counts(spec: SystemSpec, positions: jnp.ndarray):
    """(C, N, 2) -> per-chain particle counts (n_A, n_B) within the
    classification circles (hybrid utils.py:104-141 semantics)."""
    lx, ly = spec.box.size_x, spec.box.size_y
    sizes = jnp.asarray([lx, ly])

    def count_in(center):
        d = positions - center
        d = d - sizes * jnp.round(d / sizes)
        return jnp.sum(jnp.linalg.norm(d, axis=-1) <= WELL_RADIUS, axis=-1)

    n_a = count_in(jnp.asarray([lx / 4, ly / 2]))
    n_b = count_in(jnp.asarray([3 * lx / 4, ly / 2]))
    return n_a, n_b


def well_state(spec: SystemSpec, positions: jnp.ndarray) -> jnp.ndarray:
    """(C, N, 2) -> (C,) float: 1 if the majority of particles sit in well
    B, 0 if in well A (the binary slow variable; within-well jitter does
    not flip it, so its autocorrelation measures barrier crossings only)."""
    n_a, n_b = well_counts(spec, positions)
    return (n_b > n_a).astype(jnp.float32)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--chains", type=int, default=256)
    parser.add_argument("--rounds", type=int, default=400)
    parser.add_argument("--moves_per_round", type=int, default=150)
    parser.add_argument("--epochs", type=int, default=40)
    parser.add_argument("--train_cap", type=int, default=102_400,
                        help="subsample training configs to the reference "
                             "A1 budget (main_algorithm_1.py:57) so chip-"
                             "scale chain counts don't inflate training")
    parser.add_argument("--out", default="ESS.md")
    parser.add_argument("--json_out", default=None)
    parser.add_argument("--exact_samples", type=int, default=4_000_000,
                        help="quadrature samples per sector per seed for "
                             "the exact-dF oracle")
    parser.add_argument("--exact_seeds", type=int, default=4)
    args = parser.parse_args(argv)

    try:
        enable_compilation_cache()
    except Exception:
        pass

    c = args.chains
    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    beta = 1.0
    half_box = float(spec.box.size_x) / 2

    positions, _ = init_alternating_wells(c, 3, 0.03)
    state0 = init_chain_state(spec, jnp.asarray(positions), jax.random.key(0),
                              0.65)
    equil = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, 5000, 500)))
    state0 = equil(state0)
    jax.block_until_ready(state0.positions)
    print(f"equilibrated {c} chains", flush=True)

    # ---- (a) plain Metropolis: rounds of local moves, record well state --
    @jax.jit
    def plain_round(s):
        s = jax.vmap(lambda t: run_moves(spec, beta, t, args.moves_per_round))(s)
        return s, well_state(spec, s.positions), s.positions

    # warm-up: compile outside the timed region
    jax.block_until_ready(plain_round(state0)[1])

    state = state0
    obs_plain, configs = [], []
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        state, w, pos = plain_round(state)
        obs_plain.append(w)
        configs.append(pos)
    obs_plain = jax.device_get(jnp.stack(obs_plain, axis=1))  # (C, T)
    dt_plain = time.perf_counter() - t0
    ess_plain = multichain_ess(obs_plain)
    crossings = int(np.sum(np.abs(np.diff(obs_plain, axis=1)) > 0.5))
    # crossing-rate upper bound: the defensible plain-side number when the
    # autocorrelation estimate is unmeasurable or inflated by pinning
    ess_plain_ub = crossing_bound_ess(obs_plain)
    print(f"plain: {dt_plain:.1f}s, {crossings} crossings, "
          f"ESS {ess_plain:.2f} (crossing-rate bound {ess_plain_ub:.1f})",
          flush=True)

    # ---- train the flow on the plain-production configs (both wells are
    # populated by the alternating init — the reference's A1 recipe) -------
    data = to_centered(jnp.concatenate(configs, axis=0), half_box)
    if data.shape[0] > args.train_cap:
        idx = np.linspace(0, data.shape[0] - 1, args.train_cap,
                          dtype=np.int64)
        data = data[jnp.asarray(idx)]
    model = build_circular_flow(3, 2, half_box, K=15, hidden_units=256,
                                num_bins=32, num_blocks=2)
    params = model.init_params(jax.random.key(1))
    t0 = time.perf_counter()
    config = TrainConfig(batch_size=min(512, int(data.shape[0])),
                         epochs=args.epochs, lr=1e-4)
    params, _, _, loss_epoch = train(model, params, data, config,
                                     jax.random.key(2))
    dt_train = time.perf_counter() - t0
    print(f"trained on {data.shape[0]} configs: fKLD "
          f"{loss_epoch[0]:.2f} -> {loss_epoch[-1]:.2f} in {dt_train:.1f}s",
          flush=True)

    # ---- (b) hybrid: same local-move budget + one flow teleport/round ----
    @jax.jit
    def hybrid_round(s):
        s = jax.vmap(lambda t: run_moves(spec, beta, t, args.moves_per_round))(s)
        res = nf_big_moves(spec, beta, s, model, params, half_box)
        n_a, n_b = well_counts(spec, res.state.positions)
        return (res.state, well_state(spec, res.state.positions),
                res.accepted, n_a, n_b)

    # warm-up compile outside the timed region (ADVICE r1)
    jax.block_until_ready(hybrid_round(state0)[1])

    state = state0
    obs_h, acc, cnt_a, cnt_b = [], [], [], []
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        state, w, a, n_a, n_b = hybrid_round(state)
        obs_h.append(w)
        acc.append(a)
        cnt_a.append(n_a)
        cnt_b.append(n_b)
    obs_h = jax.device_get(jnp.stack(obs_h, axis=1))  # (C, T)
    dt_h = time.perf_counter() - t0
    acceptance = float(jnp.mean(jnp.stack(acc)))
    # discard the first third as hybrid burn-in (teleports re-equilibrate
    # the 50/50 init toward the true well ratio)
    burn = args.rounds // 3
    burn_note = f"first {burn}/{args.rounds} rounds discarded"
    ess_h = multichain_ess(obs_h[:, burn:])
    ess_h_geyer = effective_sample_size(obs_h[:, burn:])
    # ΔF = ln(P_B/P_A) from per-particle occupancy counts; the matching
    # exact value comes from the sector quadrature (exact_particle_df —
    # NOT the pure-sector 1.490).  Uncertainty: SEM of the per-chain ΔF
    # estimates (chains are independent given the fixed trained flow).
    cnt_a_arr = np.asarray(jax.device_get(jnp.stack(cnt_a[burn:])))  # (T, C)
    cnt_b_arr = np.asarray(jax.device_get(jnp.stack(cnt_b[burn:])))
    tot_a = float(cnt_a_arr.sum())
    tot_b = float(cnt_b_arr.sum())
    df = float(np.log(tot_b / max(tot_a, 1.0)))
    chain_a = np.maximum(cnt_a_arr.sum(axis=0), 1.0)  # (C,)
    chain_b = np.maximum(cnt_b_arr.sum(axis=0), 1.0)
    chain_df = np.log(chain_b / chain_a)
    df_sem = float(np.std(chain_df, ddof=1) / np.sqrt(len(chain_df)))
    exact_df, exact_sem = exact_particle_df(args.exact_samples,
                                            args.exact_seeds)
    exact_df = round(exact_df, 4)
    # 2-sigma gate with BOTH uncertainties: the sampler's SEM and the
    # quadrature oracle's own MC error, in quadrature
    gate_tol = 2.0 * float(np.hypot(df_sem, exact_sem))
    df_ok = abs(df - exact_df) <= gate_tol
    print(f"hybrid: {dt_h:.1f}s, acceptance {acceptance:.3f}, "
          f"ESS {ess_h:.1f} (per-chain Geyer sum {ess_h_geyer:.1f}), "
          f"dF {df:.3f} +- {df_sem:.3f} "
          f"({'OK' if df_ok else 'FAILS 2-sigma gate'} vs {exact_df} "
          f"+- {exact_sem:.4f})",
          flush=True)

    ess_per_s_h = ess_h / dt_h
    ess_per_s_p = ess_plain / dt_plain
    ess_per_s_p_ub = ess_plain_ub / dt_plain
    # reliability needs enough crossings AND self-consistency with the
    # crossing-rate bound (pinned ensembles inflate the rank-normalized
    # estimate past what their crossings can support)
    plain_reliable = crossings >= 20 and ess_plain <= ess_plain_ub
    speedup = (round(ess_per_s_h / ess_per_s_p, 1)
               if plain_reliable and ess_per_s_p > 0 else None)
    # rigorous lower bound: measured hybrid over the plain UPPER bound
    speedup_lb = (round(ess_per_s_h / ess_per_s_p_ub, 1)
                  if ess_per_s_p_ub > 0 else None)
    result = {
        "metric": "well_state_ess_per_s",
        # the headline is gated on ΔF self-consistency: an effective-sample
        # count around a mean that disagrees with the exact answer is
        # meaningless (VERDICT r1, weak #1)
        "value": round(ess_per_s_h, 3) if df_ok else None,
        "unit": "ESS/s",
        "gated": None if df_ok else (
            f"|dF - exact| = {abs(df - exact_df):.3f} > 2*sigma "
            f"= {gate_tol:.3f}; headline withheld"),
        "estimator": "rank-normalized split-chain multichain ESS",
        "hybrid_ess": round(ess_h, 1),
        "hybrid_ess_geyer_sum": round(ess_h_geyer, 1),
        "plain_ess_per_s": round(ess_per_s_p, 6),
        "plain_ess_per_s_upper_bound": round(ess_per_s_p_ub, 4),
        "plain_crossings": crossings,
        "hybrid_acceptance": round(acceptance, 4),
        "hybrid_delta_f": round(df, 4),
        "hybrid_delta_f_sem": round(df_sem, 4),
        "exact_delta_f": exact_df,
        "exact_delta_f_sem": round(exact_sem, 5),
        # when plain MCMC records too few crossings its IAT (hence the
        # ratio) is unmeasurable — report null rather than a number that
        # divides by an unreliable estimate (ADVICE r1)
        "ess_speedup_vs_plain": speedup,
        # measured hybrid / plain crossing-rate UPPER bound: a rigorous
        # lower bound that exists even when the plain IAT is unmeasurable
        "ess_speedup_vs_plain_lower_bound": speedup_lb,
        "burn_rounds": burn,
        "chains": c,
        "rounds": args.rounds,
        "device": jax.devices()[0].device_kind,
    }

    with open(args.out, "w") as f:
        f.write("# ESS — well-state effective-sample-size rate "
                "(hybrid vs plain)\n\n")
        f.write("The slow observable is the per-chain well label "
                "(majority-in-B indicator).\nBoth samplers run the same "
                f"{c} chains, {args.rounds} rounds x "
                f"{args.moves_per_round} local moves; the hybrid adds one "
                "flow teleport per round\n(main_algorithm_1.py:375-422 "
                "schedule). ESS: rank-normalized split-chain multi-chain\n"
                "estimator (Vehtari et al. 2021; analysis/ess.py:"
                f"multichain_ess); hybrid burn-in = {burn_note}.\n"
                "Timed regions exclude compilation (one warm-up call per "
                "jitted round function).\n\n")
        plain_note = (" (UNRELIABLE — pinned chains; the defensible number "
                      f"is the crossing-rate bound <= {ess_plain_ub:.1f})"
                      if not plain_reliable else "")
        f.write("| quantity | plain Metropolis | NF-hybrid |\n|---|---|---|\n")
        f.write(f"| wall time | {dt_plain:.1f} s | {dt_h:.1f} s |\n")
        f.write(f"| well-state ESS | {ess_plain:.2f}{plain_note} | "
                f"{ess_h:.1f} (per-chain Geyer sum: {ess_h_geyer:.1f}) |\n")
        f.write(f"| well-state ESS/s | "
                f"{'<= %.4f (crossing-rate bound)' % ess_per_s_p_ub
                   if not plain_reliable else '%.4f' % ess_per_s_p} | "
                f"{ess_per_s_h:.2f} |\n")
        f.write(f"| well crossings observed | {crossings} | — (teleports, "
                f"acceptance {acceptance:.3f}) |\n")
        f.write(f"| ΔF = ln(P_B/P_A), per-particle occupancy | "
                f"{'n/a' if crossings == 0 else 'pinned at init split'} | "
                f"{df:.3f} ± {df_sem:.3f} (exact {exact_df} ± "
                f"{exact_sem:.4f}) |\n\n")
        if not df_ok:
            f.write(f"**HEADLINE WITHHELD**: measured ΔF differs from the "
                    f"exact value by {abs(df - exact_df):.3f} > 2·σ = "
                    f"{gate_tol:.3f}. The chain has not equilibrated at "
                    "this budget; the ESS numbers above are recorded for "
                    "diagnosis only and must not be quoted.\n\n")
        elif speedup is not None:
            f.write(f"ESS/s speedup vs plain: **{speedup:.1f}x**.\n\n")
        else:
            f.write(f"ESS/s speedup vs plain: **>= {speedup_lb}x** — a "
                    "RIGOROUS lower bound: the numerator is the measured "
                    "hybrid ESS/s and the denominator is the plain side's "
                    "crossing-rate UPPER bound (two-state-chain IAT bounded "
                    "from the Poisson-95% UCL flip rate, "
                    "analysis/ess.py:crossing_bound_ess), which exists even "
                    f"at {crossings} observed crossings where the "
                    "autocorrelation estimate itself is unmeasurable.\n\n")
        f.write(f"ΔF self-consistency gate: |ΔF − {exact_df}| = "
                f"{abs(df - exact_df):.3f} vs 2·σ = {gate_tol:.3f} "
                "(sampler SEM and quadrature-oracle SEM in quadrature) → "
                f"{'PASS' if df_ok else 'FAIL'}.\n\n")
        f.write(f"Flow: K=15 circular RQ-spline, trained {args.epochs} "
                f"epochs on the plain phase's {int(data.shape[0])} configs "
                f"({dt_train:.1f} s).\n")

    def _finite(v):
        return (None if isinstance(v, float) and not np.isfinite(v) else v)

    clean = {k: _finite(v) for k, v in result.items()}
    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(clean, f, indent=1)
    print(json.dumps(clean))
    return result


if __name__ == "__main__":
    main()
