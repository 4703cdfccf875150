"""Experiment drivers: baseline MCMC, hybrid algorithms, single runs, sweeps.

Submodules load lazily so ``python -m flowstate.experiments.<driver>``
does not double-import the driver module.
"""

import importlib

__all__ = ["mcmc_only", "algorithm1", "algorithm2", "single_run", "sweep",
           "train_npz"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"flowstate.experiments.{name}")
    raise AttributeError(name)
