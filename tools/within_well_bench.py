"""Within-well decorrelation: Metropolis vs MALA vs HMC at their actual job.

VERDICT r3 item 3: SAMPLERS.md shows the gradient samplers losing every
row on the BARRIER observable (they cannot cross 10 k_BT walls — nothing
can, locally) and defends them with an unmeasured "within-well
decorrelation" claim.  This tool measures that claim: a SINGLE-well
system (num_wells=1, no barrier to cross), chains equilibrated in the
well, and the fast observables' ESS/s — energy/N and the mean x
coordinate — for the three local samplers, at N=3 and N=32.

Budget shape per round:
  Metropolis  50*N single-particle moves  (50 sweeps, no gradients)
  MALA        25 whole-config moves       (2 grad evals each = 50 grads)
  HMC         5 trajectories, L=10        (11 grad evals each = 55 grads)

MALA and HMC are gradient-matched to ~10%; Metropolis is matched in
SWEEPS (each move touches one particle).  The cross-sampler verdict
metric is wall-clock ESS/s on the same chip — each sampler spends its
budget however it likes.  ESS: rank-normalized multichain (Vehtari et
al.), burn-in first third.

Writes results/evidence/within_well.json and splices the section into
SAMPLERS.md (idempotent, marker-delimited).

Usage (on the GPU): python tools/within_well_bench.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.utils.profiling import enable_compilation_cache

try:
    enable_compilation_cache()
except Exception:
    pass

from flowstate.analysis.ess import multichain_ess
from flowstate.mcmc import (
    init_chain_state, run_equilibration, run_hmc, run_hmc_equilibration,
    run_mala, run_mala_equilibration, run_moves,
)
from flowstate.mcmc.initialise import initialise_low_left
from flowstate.ops import Box, SystemSpec

SECTION_BEGIN = "<!-- within-well:begin -->"
SECTION_END = "<!-- within-well:end -->"


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


def _observe(spec, s):
    """(energy/N, mean-x) per chain."""
    return (s.energy / spec.num_particles,
            jnp.mean(s.positions[..., 0], axis=-1))


def scan_rounds(spec, move_fn, rounds):
    @jax.jit
    def run(s):
        def body(st, _):
            st = move_fn(st)
            return st, _observe(spec, st)
        s, (e, x) = jax.lax.scan(body, s, None, length=rounds)
        return s, e, x
    return run


def bench_system(n, chains, rounds, n_leap=10, sweeps_per_round=50):
    """Rows for one particle count."""
    # one well only: V0=-10 at (Lx/4, Ly/2); nothing to cross
    box = Box.from_density(n, 0.03, 1.0)
    spec = SystemSpec.create(n, box, num_wells=1, V0_list=(-10.0,),
                             r0=1.2, k=15.0)
    beta = 1.0

    if n <= 12:
        pos, _ = initialise_low_left(n, 0.03)
    else:
        from flowstate.mcmc.initialise import initialise_fcc_left_half
        pos, _ = initialise_fcc_left_half(n, 0.03, 1.0)
    pos = jnp.broadcast_to(jnp.asarray(pos), (chains, n, 2))
    # jitter so chains decorrelate from the shared lattice start
    pos = pos + jax.random.uniform(jax.random.key(5), pos.shape,
                                   minval=-0.05, maxval=0.05)
    state0 = init_chain_state(spec, pos, jax.random.key(0), 0.65)
    # >= 150 sweeps regardless of N (5000 single-particle moves is only
    # 39 sweeps at N=128 — not enough from a half-lattice start)
    equil = max(5000, 150 * n)
    state0 = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, equil, 500)))(state0)
    jax.block_until_ready(state0.positions)
    print(f"N={n}: equilibrated {chains} chains "
          f"(E/N={float(state0.energy.mean())/n:.2f})", flush=True)

    mpr_metro = sweeps_per_round * n
    mpr_mala = sweeps_per_round // 2           # 2 grads/move
    traj_hmc = max(1, sweeps_per_round // (n_leap + 1))

    budgets = {
        "metropolis": {"moves_per_round": mpr_metro, "grads_per_round": 0},
        "mala": {"moves_per_round": mpr_mala,
                 "grads_per_round": 2 * mpr_mala},
        "hmc": {"moves_per_round": traj_hmc,
                "grads_per_round": traj_hmc * (n_leap + 1)},
    }

    rows = []

    def finish(name, s0, s_end, e, x, dt):
        burn = rounds // 3
        e = np.asarray(e).T  # (C, T)
        x = np.asarray(x).T
        ess_e = multichain_ess(e[:, burn:])
        ess_x = multichain_ess(x[:, burn:])
        acc = float((s_end.accepts - s0.accepts).sum()
                    / max(1, (s_end.attempts - s0.attempts).sum()))
        grads = budgets[name]["grads_per_round"] * rounds
        row = {"sampler": name, "n": n, "wall_s": round(dt, 2),
               "acceptance": round(acc, 4),
               "energy_ess": round(float(ess_e), 1),
               "energy_ess_per_s": round(float(ess_e) / dt, 1),
               "meanx_ess": round(float(ess_x), 1),
               "meanx_ess_per_s": round(float(ess_x) / dt, 1),
               "grad_evals_per_chain": grads,
               **budgets[name]}
        if grads:
            row["energy_ess_per_Mgrad"] = round(
                float(ess_e) / (grads * chains / 1e6), 1)
        rows.append(row)
        print(row, flush=True)

    # Metropolis
    metro = scan_rounds(spec, jax.vmap(
        lambda t: run_moves(spec, beta, t, mpr_metro)), rounds)
    (s_end, e, x), dt = _timed(metro, state0)
    finish("metropolis", state0, s_end, e, x, dt)

    # MALA (re-adapt tau from the gradient-sampler starting point)
    mala0 = jax.jit(jax.vmap(lambda s: run_mala_equilibration(
        spec, beta, s, 1000, 100)))(state0._replace(
            max_disp=jnp.full_like(state0.max_disp, 0.02),
            prev_attempts=state0.attempts, prev_accepts=state0.accepts))
    jax.block_until_ready(mala0.positions)
    mala = scan_rounds(spec, jax.vmap(
        lambda t: run_mala(spec, beta, t, mpr_mala)), rounds)
    (s_end, e, x), dt = _timed(mala, mala0)
    finish("mala", mala0, s_end, e, x, dt)

    # HMC
    hmc0 = jax.jit(jax.vmap(lambda s: run_hmc_equilibration(
        spec, beta, s, 500, 50, n_leap)))(state0._replace(
            max_disp=jnp.full_like(state0.max_disp, 0.05),
            prev_attempts=state0.attempts, prev_accepts=state0.accepts))
    jax.block_until_ready(hmc0.positions)
    hmc = scan_rounds(spec, jax.vmap(
        lambda t: run_hmc(spec, beta, t, traj_hmc, n_leap)), rounds)
    (s_end, e, x), dt = _timed(hmc, hmc0)
    finish("hmc", hmc0, s_end, e, x, dt)

    return rows


def build_verdict(rows) -> str:
    """Both-observable verdict: a sampler only 'wins' a system if it
    leads on energy ESS/s without collapsing on mean-x."""
    m = {(r["n"], r["sampler"]): r for r in rows}
    ns = sorted({r["n"] for r in rows})

    def f(n, s, k):
        return m[(n, s)][k]

    per_n = []
    for n in ns:
        e = {s: f(n, s, "energy_ess_per_s")
             for s in ("metropolis", "mala", "hmc")}
        x = {s: f(n, s, "meanx_ess_per_s")
             for s in ("metropolis", "mala", "hmc")}
        best_e = max(e, key=e.get)
        both = best_e == max(x, key=x.get)
        per_n.append(
            f"N={n}: energy ESS/s {e['metropolis']:.0f} / {e['mala']:.0f} "
            f"/ {e['hmc']:.0f} (Metropolis/MALA/HMC), mean-x "
            f"{x['metropolis']:.0f} / {x['mala']:.0f} / {x['hmc']:.0f} — "
            f"best {'on both observables' if both else 'on energy only'}: "
            f"{best_e}")
    return (
        "Verdict: "
        + "; ".join(per_n) + ".  "
        "Whole-config gradient steps shrink as d^(-1/4..-1/3) with "
        "dimension while single-particle displacements stay O(1), and "
        "the batched engine makes the N-fold move-count advantage free "
        "(vectorized, gradient-free) — so Metropolis holds the wall-"
        "clock lead unless/until the gradient samplers overtake on the "
        "slowest observable at large N (see the N=128 row).  When to "
        "use MALA/HMC: as PT per-replica kernels or when per-Mgrad "
        "efficiency matters (HMC beats MALA "
        f"{f(ns[0],'hmc','energy_ess_per_Mgrad'):.0f} vs "
        f"{f(ns[0],'mala','energy_ess_per_Mgrad'):.0f} ESS/Mgrad at "
        f"N={ns[0]}).")


def render_section(data) -> str:
    """The SAMPLERS.md within-well section (shared with sampler_bench)."""
    sys_desc = " / ".join(f"{c} chains at N={n}"
                          for n, c in data["systems"])
    lines = [SECTION_BEGIN,
             "",
             "## Within-well decorrelation (the gradient samplers' "
             "actual job)",
             "",
             "Single-well system (num_wells=1, V0=-10 — no barrier), "
             f"{sys_desc}, {data['rounds']} rounds; per round Metropolis "
             "runs 50 sweeps (50N single-particle moves), MALA 25 "
             "whole-config moves (50 grad evals), HMC 5 trajectories of "
             "L=10 leapfrog steps (55 grad evals) — MALA and HMC "
             "gradient-matched to ~10%, Metropolis sweep-matched.  Fast "
             "observables (energy/N and mean x), rank-normalized "
             "multichain ESS, burn-in first third.",
             "",
             "| N | sampler | acceptance | energy ESS/s | mean-x ESS/s | "
             "ESS per Mgrad (energy) |",
             "|---|---|---|---|---|---|"]
    for row in data["rows"]:
        lines.append(
            f"| {row['n']} | {row['sampler']} | {row['acceptance']} "
            f"| {row['energy_ess_per_s']} | {row['meanx_ess_per_s']} "
            f"| {row.get('energy_ess_per_Mgrad', '—')} |")
    lines += ["", data["verdict"], "", SECTION_END]
    return "\n".join(lines)


def splice_into_samplers_md(data, path="SAMPLERS.md"):
    section = render_section(data)
    try:
        text = open(path).read()
    except FileNotFoundError:
        text = "# SAMPLERS\n"
    if SECTION_BEGIN in text:
        pre = text.split(SECTION_BEGIN)[0]
        post = text.split(SECTION_END)[-1]
        text = pre + section + post
    else:
        text = text.rstrip("\n") + "\n\n" + section + "\n"
    with open(path, "w") as f:
        f.write(text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--systems", default="3:1024,32:256,128:64",
                    help="comma list of N:chains")
    ap.add_argument("--merge", action="store_true",
                    help="keep rows for N values not rerun this time")
    args = ap.parse_args(argv)

    systems = [tuple(int(v) for v in s.split(":"))
               for s in args.systems.split(",")]
    rows = []
    for n, chains in systems:
        rows += bench_system(n, chains, args.rounds)

    if args.merge and os.path.exists("results/evidence/within_well.json"):
        prev = json.load(open("results/evidence/within_well.json"))
        prev_systems = [tuple(s) for s in prev.get(
            "systems", [(3, prev.get("chains_n3", 1024)),
                        (32, prev.get("chains_n32", 256))])]
        mine = {r["n"] for r in rows}
        rows = [r for r in prev["rows"] if r["n"] not in mine] + rows
        rows.sort(key=lambda r: r["n"])
        systems = sorted({s for s in prev_systems if s[0] not in mine}
                         | set(systems))

    verdict = build_verdict(rows)

    data = {"metric": "within_well_bench", "rows": rows,
            "rounds": args.rounds,
            "systems": [list(s) for s in systems],
            "verdict": verdict,
            "device": str(jax.devices()[0])}
    os.makedirs("results/evidence", exist_ok=True)
    with open("results/evidence/within_well.json", "w") as f:
        json.dump(data, f, indent=1)
    splice_into_samplers_md(data)
    print(json.dumps({"metric": "within_well_bench", "verdict": verdict}))
    return data


if __name__ == "__main__":
    main()
