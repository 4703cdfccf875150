"""flowstate — a hybrid normalizing-flow / MCMC inference framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
``Inesalmansa/flow-state`` codebase (a PyTorch + numpy research code coupling a
serial Metropolis Monte-Carlo sampler for a 2D Lennard-Jones double-well system
with a normalizing-flow proposal engine).

Design stance (not a port):

* The per-move object-oriented mutation of the reference
  (``MCMC/monte_carlo.py``) becomes a pure, jittable chain state advanced by
  ``lax.scan`` over moves and ``vmap``/``shard_map`` over chains.
* The flow (``NF/normflows``) becomes a pytree of spline parameters with pure
  ``forward``/``inverse``/``log_prob`` transforms.
* Drivers are thin Python orchestration around jitted phase functions.
* Scaling axis is the *chains* dimension: thousands of chains per chip via
  ``vmap``, sharded across chips/hosts via a ``jax.sharding.Mesh``.

Subpackages
-----------
ops        physics kernels: periodic box, LJ + double-well potentials,
           pair energies, rational-quadratic spline math
flows      normalizing-flow library (couplings, nets, bases, targets, model)
mcmc       batched Metropolis engine, hybrid flow-MH moves, initialisers
training   optax training loops (forward/reverse KLD), data pipeline
parallel   device mesh / sharding utilities, multi-host helpers
analysis   observables: well statistics, RDF, state histograms, plots
utils      config, logging, checkpointing, metrics
experiments  the three reference drivers: mcmc_only, algorithm 1, algorithm 2
"""

__version__ = "0.1.0"

from flowstate import ops  # noqa: F401
