"""Mitigating the N>3 big-move acceptance collapse: a measured ladder.

tools/hybrid_n_scaling.py measured the wall: at the A1 recipe budget
(K=15, hidden 256, 40 epochs) flow independence proposals collapse from
9.5% acceptance at N=3 to 7e-4 at N=8 and <4e-5 at N>=16.  This tool
runs the mitigation ladder VERDICT r3 item 1 asks for — what the
library already has, measured one axis at a time at fixed data:

  base      K=15 h=256 res-net, 40 epochs   (replicates the wall row)
  epochs    same flow, 200 epochs           (is it under-training?)
  deeper    K=23, 200 epochs                (is it expressiveness?)
  data4x    4x local data, 200 epochs       (is it data volume?)
  transformer / gnn param nets              (is it particle symmetry?)

For every rung it records acceptance AND the MH log-ratio moments: for
an independence sampler the acceptance is governed by the distribution
of log r = -beta dU + log q(old) - log q(new); a mean << 0 with large
std is the quantitative signature of q underfitting pi, and its drift
with N measures the dimension wall directly.

Writes results/evidence/n_mitigation.json.
Usage (on the GPU): python tools/n_mitigation.py --n 8
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

from hybrid_n_scaling import init_split_wells

from flowstate.flows import build_circular_flow
from flowstate.mcmc import (
    init_chain_state, nf_big_moves, run_equilibration, run_moves,
)
from flowstate.mcmc.hybrid import to_centered
from flowstate.ops import Box, SystemSpec
from flowstate.training import TrainConfig, train


def split_acceptance(spec, beta, model, params, half_box, state0,
                     acc_rounds):
    """Big-move acceptance measured with three SEPARATE jitted programs
    per round + host MH arithmetic — numerically the same estimator as
    the fused acc scan (same proposal draws, same ratio, same state
    update), used when the fused program is too large to compile (the
    transformer rung)."""
    from flowstate.ops.pair_energy import total_energy_virial

    c = state0.positions.shape[0]
    n = spec.num_particles
    sample_fn = jax.jit(
        lambda p, k: model.sample_and_log_prob(p, k, c))
    logprob_fn = jax.jit(model.log_prob)
    energy_fn = jax.jit(
        jax.vmap(lambda p: total_energy_virial(spec, p)[0]))

    positions = np.asarray(state0.positions)
    energy = np.asarray(state0.energy)
    rng = np.random.default_rng(7)
    accs, rlogs = [], []
    for rd in range(acc_rounds):
        prop_flat, log_q_new = sample_fn(params, jax.random.key(1000 + rd))
        proposals = np.asarray(prop_flat).reshape(c, n, 2) + half_box
        log_q_old = np.asarray(logprob_fn(
            params, jnp.asarray((positions - half_box).reshape(c, -1))))
        enn = np.asarray(energy_fn(jnp.asarray(proposals)))
        ratio_log = -beta * (enn - energy) + (log_q_old
                                              - np.asarray(log_q_new))
        u = rng.uniform(size=c)
        accept = u < np.exp(np.minimum(ratio_log, 0.0))
        positions = np.where(accept[:, None, None], proposals, positions)
        energy = np.where(accept, enn, energy)
        accs.append(accept.astype(np.float32))
        rlogs.append(ratio_log)
    return np.stack(accs), np.stack(rlogs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--chains", type=int, default=510)
    ap.add_argument("--collect_rounds", type=int, default=100)
    ap.add_argument("--moves_per_round", type=int, default=150)
    ap.add_argument("--acc_rounds", type=int, default=200)
    ap.add_argument("--rungs",
                    default="base,epochs,deeper,data4x,transformer,gnn")
    ap.add_argument("--json_out",
                    default="results/evidence/n_mitigation.json")
    args = ap.parse_args(argv)

    n, c = args.n, args.chains
    spec = SystemSpec.create(n, Box.from_density(n, 0.03, 1.0), num_wells=2,
                             V0_list=(-10.0, -10.5), r0=1.2, k=15.0)
    beta = 1.0
    half_box = float(spec.box.size_x) / 2

    pos, _ = init_split_wells(c, n, 0.03)
    state0 = init_chain_state(spec, pos, jax.random.key(n), 0.65)
    state0 = jax.jit(jax.vmap(
        lambda s: run_equilibration(spec, beta, s, 20000, 500)))(state0)
    jax.block_until_ready(state0.positions)
    print(f"N={n}: equilibrated {c} chains", flush=True)

    def collect(rounds):
        @jax.jit
        def go(s):
            def body(st, _):
                st = jax.vmap(lambda t: run_moves(
                    spec, beta, t, args.moves_per_round))(st)
                return st, st.positions
            return jax.lax.scan(body, s, None, length=rounds)
        _, configs = go(state0)
        return to_centered(jnp.reshape(configs, (-1, n, 2)), half_box)

    data1x = collect(args.collect_rounds)
    print(f"N={n}: {data1x.shape[0]} local configs (1x)", flush=True)

    RUNGS = {
        "base": dict(K=15, hidden=256, epochs=40, net="residual", data=1),
        "epochs": dict(K=15, hidden=256, epochs=200, net="residual", data=1),
        "deeper": dict(K=23, hidden=256, epochs=200, net="residual", data=1),
        "data4x": dict(K=15, hidden=256, epochs=200, net="residual", data=4),
        # split=True: the transformer TRAIN program compiles and runs via
        # ScannedLayers (r5: 9.4 s compile), and sample_and_log_prob /
        # log_prob / energies each work standalone — but the FUSED
        # big-move program (all three in one jit) failed to compile in
        # earlier rounds.  The acceptance is
        # therefore measured with the identical estimator split into
        # three jitted programs per round + host MH arithmetic.
        "transformer": dict(K=15, hidden=256, epochs=100, net="transformer",
                            data=1, split=True),
        "gnn": dict(K=15, hidden=64, epochs=100, net="gnn", data=1),
    }

    data4x = None
    rows = []
    for rung in args.rungs.split(","):
        r = RUNGS[rung]
        if r["data"] == 4:
            if data4x is None:
                data4x = jnp.concatenate(
                    [data1x, collect(3 * args.collect_rounds)])
                print(f"N={n}: {data4x.shape[0]} local configs (4x)",
                      flush=True)
            data = data4x
        else:
            data = data1x
        model = build_circular_flow(n, 2, half_box, K=r["K"],
                                    hidden_units=r["hidden"],
                                    num_bins=32, num_blocks=2,
                                    net_type=r["net"])
        params = model.init_params(jax.random.key(1))
        tcfg = TrainConfig(batch_size=512, epochs=r["epochs"], lr=1e-4)
        t0 = time.perf_counter()
        try:
            params, _, _, loss_epoch = train(model, params, data, tcfg,
                                             jax.random.key(2))
            dt_train = time.perf_counter() - t0

            if r.get("split"):
                acc, rlog = split_acceptance(spec, beta, model, params,
                                             half_box, state0,
                                             args.acc_rounds)
            else:
                @jax.jit
                def acc_scan(s):
                    def body(st, _):
                        res = nf_big_moves(spec, beta, st, model, params,
                                           half_box)
                        return res.state, (res.accepted.astype(jnp.float32),
                                           res.ratio_log)
                    return jax.lax.scan(body, s, None,
                                        length=args.acc_rounds)

                _, (acc, rlog) = acc_scan(state0)
        except Exception as e:
            # e.g. a compile failure on very large unscanned programs —
            # record, don't die
            print(f"{rung}: FAILED {e!r}"[:400], flush=True)
            rows.append({"rung": rung, "error": repr(e)[:300]})
            continue
        acc = np.asarray(acc)
        rlog = np.asarray(rlog).ravel()
        finite = rlog[np.isfinite(rlog)]
        row = {
            "rung": rung, **{k: r[k] for k in ("K", "hidden", "epochs",
                                               "net")},
            "train_configs": int(data.shape[0]),
            "train_wall_s": round(dt_train, 1),
            "fkld_first": round(float(loss_epoch[0]), 3),
            "fkld_last": round(float(loss_epoch[-1]), 3),
            "proposals": int(acc.size),
            "acceptance": round(float(acc.mean()), 6),
            # log-ratio moments: mean << 0, large std = q underfits pi
            "ratio_log_mean": round(float(finite.mean()), 2),
            "ratio_log_std": round(float(finite.std()), 2),
            "ratio_log_p99": round(float(np.percentile(finite, 99)), 2),
            "ratio_log_frac_inf": round(
                float(1.0 - finite.size / rlog.size), 4),
        }
        rows.append(row)
        print(row, flush=True)

    out = {"metric": "n_mitigation", "n": n, "chains": c,
           "device": str(jax.devices()[0]), "rows": rows}
    os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
    path = args.json_out
    if os.path.exists(path):  # merge across invocations: same-n rung rows
        prev = json.load(open(path))
        systems = prev.get("systems", [prev] if "rows" in prev else [])
        mine = [s for s in systems if s.get("n") == n]
        if mine:
            kept = [r for r in mine[0]["rows"]
                    if r.get("rung") not in {q.get("rung")
                                             for q in out["rows"]}]
            out["rows"] = kept + out["rows"]
        systems = [s for s in systems if s.get("n") != n] + [out]
        out = {"metric": "n_mitigation", "systems": systems}
    else:
        out = {"metric": "n_mitigation", "systems": [out]}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"metric": "n_mitigation", "n": n,
                      "rungs": [r.get("rung") for r in rows]}))
    return out


if __name__ == "__main__":
    main()
