"""Config, logging, checkpointing, metrics."""

from flowstate.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from flowstate.utils.config import (
    ExperimentConfig,
    algorithm1_config,
    algorithm2_config,
    mcmc_only_config,
)
from flowstate.utils.logging import MetricsWriter, save_params_json, setup_logger
from flowstate.utils.profiling import (
    PhaseTimer,
    annotate,
    enable_compilation_cache,
    trace,
)

__all__ = [
    "ExperimentConfig", "algorithm1_config", "algorithm2_config",
    "mcmc_only_config",
    "setup_logger", "MetricsWriter", "save_params_json",
    "save_checkpoint", "restore_checkpoint", "latest_checkpoint",
    "PhaseTimer", "annotate", "trace", "enable_compilation_cache",
]
