"""Algorithm 1 demo — equivalent of demos/hybrid_nf_mcmc_algorithm_1_demo.ipynb.

Reference demo scale: 10 chains, 10,240 training samples, 20 epochs,
20 big moves per chain (the notebook reports ~31 min total on an M1 CPU;
here it runs batched on one accelerator).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flowstate.experiments import algorithm1
from flowstate.utils.config import algorithm1_config


def main(smoke=False):
    # smoke=True: CI-scale run (seconds on CPU) exercising the same path
    if smoke:
        config = algorithm1_config(
            experiment_id="a1_demo", output_dir="demo_results",
            num_chains=4, equilibration_steps=300, adjusting_frequency=100,
            initial_training_num_samples=512, sampling_frequency=10,
            batch_size=128, epochs=2, K=3, hidden_units=32, num_bins=8,
            big_move_attempts=5, big_move_interval=20,
            num_samples_for_analysis=512)
    else:
        config = algorithm1_config(
            experiment_id="a1_demo", output_dir="demo_results",
            num_chains=10, equilibration_steps=5000,
            initial_training_num_samples=10240, sampling_frequency=150,
            batch_size=512, epochs=20, K=15, hidden_units=256, num_bins=32,
            big_move_attempts=20, big_move_interval=100,
            num_samples_for_analysis=10000)
    results = algorithm1.run(config)
    print("Demo finished:", results)
    return results


if __name__ == "__main__":
    main(smoke="--smoke" in sys.argv)
