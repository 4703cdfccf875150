"""Tighter N-scaling ΔF oracle: MBAR-pool the WHOLE PT ladder.

tools/hybrid_n_scaling.py validates the N=8/16/32 hybrid against the PT
cold replica only — R-1 replicas' samples are thrown away.  This tool
reweights ALL R x M samples to the cold state with MBAR
(analysis/mbar.py) and computes the particle-level
ΔF = ln(E[n_B]/E[n_A]) there, with a block error bar, giving the
N-scaling table a tighter oracle and exercising the MBAR subsystem on
the exact workload it exists for (capability the reference lacks —
SURVEY.md §5 lists only the occupancy-ratio ΔF).

Writes the result into results/evidence/hybrid_n_scaling.json under
each system's "pt_mbar" key.

Usage (on the GPU): python tools/pt_mbar_oracle.py --n_list 8,16,32
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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

from ess_check import well_counts
from hybrid_n_scaling import init_split_wells

from flowstate.analysis.mbar import mbar_free_energies, mbar_log_weights
from flowstate.mcmc import (
    init_tempered_state, run_equilibration, run_replica_exchange,
    temperature_ladder,
)
from flowstate.ops import Box, SystemSpec


def weighted_particle_df(log_w: np.ndarray, n_a: np.ndarray,
                         n_b: np.ndarray) -> float:
    """ln(E[n_B]/E[n_A]) under normalized weights exp(log_w)."""
    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    return float(np.log(max((w * n_b).sum(), 1e-300)
                        / max((w * n_a).sum(), 1e-300)))


def run_for_n(n: int, args) -> dict:
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    r = args.replicas
    walkers = args.walkers
    betas = temperature_ladder(1.0, args.t_hot, r)
    pos, _ = init_split_wells(walkers, n, 0.03)
    st = init_tempered_state(
        spec, jnp.broadcast_to(jnp.asarray(pos), (r, walkers, n, 2)),
        jax.random.key(300 + n), 0.65)
    st = jax.jit(jax.vmap(lambda b, s: jax.vmap(
        lambda t: run_equilibration(spec, b, t, 2000, 500))(s)))(betas, st)
    jax.block_until_ready(st.positions)

    @jax.jit
    def pt(state):
        return run_replica_exchange(
            spec, betas, state, jax.random.key(400 + n), args.pt_rounds,
            args.moves_per_round, record="all")

    res = pt(st)
    # burn-in: drop the first third of rounds
    burn = args.pt_rounds // 3
    pos = np.asarray(res.cold_positions[burn:])      # (T, R, W, N, 2)
    energies = np.asarray(res.cold_energy[burn:])  # (T, R, W)
    t = pos.shape[0]

    n_a, n_b = well_counts(spec, jnp.asarray(pos.reshape(-1, n, 2)))
    n_a = np.asarray(n_a).reshape(t, r, walkers)
    n_b = np.asarray(n_b).reshape(t, r, walkers)

    # cold-replica-only estimate (the hybrid_n_scaling oracle)
    df_cold = float(np.log(max(n_b[:, 0].sum(), 1.0)
                           / max(n_a[:, 0].sum(), 1.0)))

    # MBAR over the pooled ladder: u_kn = beta_k * E_n
    e_n = energies.transpose(1, 0, 2).reshape(r, -1)   # (R, M) M = T*W
    m = e_n.shape[1]
    # x64 for the ΔF analysis (the repo convention, tempering_check.py):
    # without it JAX silently keeps fp32 despite mbar.py's float64 casts,
    # and over ~300k pooled samples across a 1.0-0.1 beta ladder the fp32
    # logsumexp error is comparable to the reported SEM (r4 advisor)
    with jax.enable_x64(True):
        u_kn = (jnp.asarray(betas, jnp.float64)[:, None]
                * jnp.asarray(e_n.reshape(-1), jnp.float64)[None, :])
        n_k = jnp.full((r,), m)
        f_k = mbar_free_energies(u_kn, n_k, num_iters=args.mbar_iters)
        log_w = np.asarray(mbar_log_weights(u_kn, n_k, f_k, 0))  # cold

    na_pool = n_a.transpose(1, 0, 2).reshape(-1)
    nb_pool = n_b.transpose(1, 0, 2).reshape(-1)
    df_mbar = weighted_particle_df(log_w, na_pool, nb_pool)

    # block error bar: 5 round-blocks, shared f_k
    blocks = []
    w_idx = np.arange(r * m).reshape(r, t, walkers)
    for b in range(5):
        sel = np.zeros(r * m, bool)
        rows = slice(b * t // 5, (b + 1) * t // 5)
        sel[w_idx[:, rows].reshape(-1)] = True
        blocks.append(weighted_particle_df(
            np.where(sel, log_w, -np.inf), na_pool, nb_pool))
    sem = float(np.std(blocks) / np.sqrt(len(blocks)))

    out = {"df_particle_mbar": round(df_mbar, 4),
           "df_particle_mbar_sem": round(sem, 4),
           "df_particle_cold_only": round(df_cold, 4),
           "pooled_samples": int(r * m),
           "f_k": [round(float(x), 3) for x in np.asarray(f_k)],
           "ladder": f"{r}x{walkers}, T_hot={args.t_hot}",
           "pt_rounds": args.pt_rounds}
    print(f"N={n}: MBAR dF={df_mbar:.4f} +- {sem:.4f} "
          f"(cold-only {df_cold:.4f}, {r * m} pooled samples)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_list", default="8,16,32")
    ap.add_argument("--replicas", type=int, default=10)
    ap.add_argument("--walkers", type=int, default=51)
    ap.add_argument("--pt_rounds", type=int, default=600)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--t_hot", type=float, default=10.0)
    ap.add_argument("--mbar_iters", type=int, default=500)
    ap.add_argument("--json_out",
                    default="results/evidence/hybrid_n_scaling.json")
    args = ap.parse_args(argv)

    results = {}
    for n in [int(x) for x in args.n_list.split(",")]:
        results[n] = run_for_n(n, args)
        if os.path.exists(args.json_out):
            doc = json.load(open(args.json_out))
            for s in doc.get("systems", []):
                if s["n"] == n:
                    s["pt_mbar"] = results[n]
            with open(args.json_out, "w") as f:
                json.dump(doc, f, indent=1)
    print(json.dumps({"metric": "pt_mbar_oracle",
                      "df": {k: v["df_particle_mbar"]
                             for k, v in results.items()}}))
    return results


if __name__ == "__main__":
    main()
