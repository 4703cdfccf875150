"""MCMC demo — script equivalent of the reference's demos/MCMC_demo.ipynb.

A short baseline run of the batched engine on the 3-particle LJ double-well
system with plots of the sampled trajectory.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flowstate.experiments import mcmc_only
from flowstate.utils.config import mcmc_only_config


def main(smoke=False):
    # smoke=True: CI-scale run (seconds on CPU) exercising the same path
    scale = 50 if smoke else 1
    config = mcmc_only_config(
        experiment_id="mcmc_demo", output_dir="demo_results",
        num_chains=4 if smoke else 10,
        equilibration_steps=5000 // scale,
        sampling_frequency=150 // scale, adjusting_frequency=5000 // scale)
    results = mcmc_only.run(config,
                            total_production_steps=1_000_000 // scale)
    print("Demo finished:", results)
    return results


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
