#!/bin/bash
# Re-run the headline physics experiments with committed-evidence emission
# (VERDICT r2 item 7).  Jobs run strictly sequentially: one JAX process
# per card.
set -x
cd "$(dirname "$0")/.."
mkdir -p logs results/evidence

timeout 1800 python -m flowstate.experiments.mcmc_only \
  --experiment_id mcmc_only_fullscale_r3 > logs/mcmc_only_full_r3.log 2>&1
echo "mcmc_only rc=$?"

timeout 3600 python -m flowstate.experiments.algorithm2 \
  --experiment_id a2_fused_r3 --fused > logs/a2_fused_r3.log 2>&1
echo "a2_fused rc=$?"
timeout 1200 python tools/sector_check.py results/a2_fused_r3/production_positions.npy \
  --out /tmp/sectors_fused_r3.md --json_out results/evidence/a2_fused_r3_sectors.json \
  > logs/sector_fused_r3.log 2>&1
echo "sector_fused rc=$?"

timeout 5400 python -m flowstate.experiments.algorithm2 \
  --experiment_id a2_freeze_r3 --fused --freeze_after 500 > logs/a2_freeze_r3.log 2>&1
echo "a2_freeze rc=$?"
timeout 1200 python tools/sector_check.py results/a2_freeze_r3/production_positions.npy \
  --out /tmp/sectors_freeze_r3.md --json_out results/evidence/a2_freeze_r3_sectors.json \
  > logs/sector_freeze_r3.log 2>&1
echo "sector_freeze rc=$?"
echo ALL_DONE
